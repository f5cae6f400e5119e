#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

1. Builds every CUDA source of the port (one nvcc per source, started
   together) into build/kernels/.
2. Kernel phase: each hand-written kernel against its plain PyTorch
   version on the card — the forward at the serving prefill and the
   training shape, the backward kernels at the training shape (b 8,
   2048 tokens, 8 heads over 4 kv heads, window 1024), fp32 and bf16,
   every kernel at the d-12 LM's shape in both dtypes, and small edge
   cases (also at head dims 13 and 36; the wgmma kernels' narrow
   instances, head_dim <= 32, at d 8 to 32 under causal, window,
   kv_offset, ragged, GQA and MQA cases, the forward's also with more
   work items than the card has SMs, each launched twice for bit
   equality) — with its time, the plain
   version's time, the least time the card could take (bound) and one
   PyTorch library call computing the same function, timed as a
   yardstick only. bf16 at a head_dim that is a multiple of 8 takes the
   wgmma tensor-core kernels (flash_fwd_sm90, flash_bwd_dq_sm90,
   flash_bwd_dkv_sm90); every other float32 or bf16 head_dim the
   split-TF32 tensor-core kernels (flash_fwd_tf32x3,
   flash_bwd_dq_tf32x3, flash_bwd_dkv_tf32x3). Each bf16 case of the
   wgmma route is held twice more: to the derived bound of bf16 P and dS
   against the float32 plain version, and tightly against the plain
   version with P and dS split into bf16 hi + lo as the kernels split
   them; each case of the split-TF32 route, float32 or bf16, against the
   plain version that splits every product 3xTF32 as the kernels do, at
   the float32 tolerance (a bf16 o within one bf16 ulp).
3. Serving path: a REST server on the card serving the tutorial's LM
   (vocab 32000, d_model 512, 8 layers, 8 heads over 4 kv heads, window
   1024, random weights from seed 0), four concurrent predicts of
   1100-1500-token prompts, 32 greedy tokens each, sent twice (cold,
   then warm), float32: every prefill layer runs flash_fwd_tf32x3 and
   nothing else. Each stream must equal the port's solo ``generate``;
   the prefill logits through the kernel must agree with the dense path.
   Paged path (the ``paged`` line): the same prompts through ``kv:
   "paged"`` (16-token pages, the pool at the slot cache's bytes: 513
   pages) must give the slot session's and solo ``generate``'s tokens
   with 8 flash_fwd_tf32x3 launches a prefill; the 1500-token prompt
   again is a prefix hit with no launch, a prompt sharing 1024 tokens
   reuses 64 pages; 16 streams of 64-448 prompt tokens decode at once on
   the same 513 pages; int8 KV with int8 weights must stamp a drift of at
   most 0.05, fp8 weights are measured (and degrade at create where their
   drift is over it), and a drift max of 1e-9 must degrade a session to
   exact, which then answers the exact tokens; a profiled paged decode
   step beside the serving phase's slot one.
4. Training path: ``LanguageModel.fit`` of the same LM from
   ``init_params(seed 0)`` on 64 windows of 2048 tokens of a
   cyclic-successor stream, batch 16, 2 epochs, grad_accum 2, bf16
   compute: the loss must be finite, fall, and stay within 1% of the
   first (CUDA-core) kernels' epoch losses, and the forward, dq and dK/dV must
   run once per layer and micro-batch, all three on the tensor-core
   route. A profiler window of 2 steps gives the kernels' time per step
   and the card's idle share. A float32 window of the same fit (2
   optimizer steps of 16 windows, grad_accum 2) runs the split-TF32
   kernels and reports its own step time and profile (the
   ``trainFloat32`` line). In float32 one micro-step's gradients
   through the kernels must match the dense path's, for the tutorial LM
   (split-TF32 kernels) and for a small LM with head_dim 12 (d_model
   96, 8 heads: the split-TF32 kernels' width-16 variants); the same
   small LM takes one bf16 micro-step through the same kernels.
   The trained artifact is then served over REST and must answer with
   its reloaded copy's ``generate``.
5. Pipeline path: the tutorial's LM workflow over HTTP only, on a
   RestServer whose context is on the card, bf16 compute: the train
   phase's 64 windows as a CSV through ``POST /dataset/csv`` (the first
   page must hold the metadata document and the first window, ``$corpus``
   the windows exactly), ``POST /model/tensorflow`` of the tutorial LM
   through the JAX package's module path, ``POST /train/tensorflow``
   ``fit`` with the tutorial's ``"checkpoint": true`` (its epoch losses
   must equal the train phase's, with 8 layers x 16 micro-batches of each
   wgmma kernel and nothing else, and a verified step dir after each
   epoch), ``evaluate`` (within 1e-6 relative of the train phase's
   model), ``generate`` of 32 tokens after 1100 (equal to the reloaded
   artifact's solo ``generate``; its float32 prefill on
   flash_fwd_tf32x3) and ``POST /serve`` of the trained artifact (the
   same tokens). Resume: a 1-epoch checkpointed fit PATCHed to 2 epochs
   restores its step and trains epoch 2 with the uninterrupted fit's loss
   bit for bit (params and evaluate equal too); again after one byte of
   the newest step is flipped (the step goes to the quarantine and the
   run restores the one before); DELETE removes the checkpoint dir. LoRA:
   a second corpus, ``enable_lora`` rank 16 on the trained LM, a 2-epoch
   fit of the adapters alone (8 layers x 8 steps of each wgmma kernel,
   the base bit-identical, every adapter moved, the loss falling),
   ``merge_lora`` (float32 evaluate within 1e-5 relative of the adapted
   model's) and the tutorial's sampled ``generate`` (equal to the merged
   artifact's solo ``generate``). A ``sliceDevices`` field must get 406
   and leave no collection; a fit on a missing ``$`` reference must end with
   ``finished`` false and an exception document. Clients poll every 0.25
   s, as the JAX package's client does.
6. Classifier path: the tutorial's TextClassifier (vocab 20000, d_model
   256, 4 layers, 8 heads over 4, head_dim 32) with ``attention="flash"``
   in bf16: a 3-epoch fit of 1024 rows of 512 tokens (lengths 64-512,
   padded; the label is whether a marker id appears) at batch 128, 4
   layers x 24 steps of each wgmma kernel (non-causal) and nothing else;
   the loss falls, ``predict`` rows sum to 1, the artifact round-trips;
   one float32 gradient micro-step through the split-TF32 kernels within
   1e-4 per-tensor relative L2 of the dense path; ``POST /model`` of the
   tutorial's body answers 201 and finishes. The kernel phase measures
   the three wgmma kernels at this shape (b 128, 512 tokens, bf16).
7. LM options path (the ``lmOptions`` line, after the pipeline): the
   tutorial LM with a mixture of experts (Mixtral-8x7B's router: 8
   experts, 2 a token; the JAX package's GELU experts, capacity factor
   1.25) from ``init_params(seed 0)``, created and fitted over REST in
   bf16 on the train phase's windows (8 layers x 16 micro-batches of each
   wgmma kernel and nothing else, the loss falling, a positive
   load-balance term, one step repeated from one state bit-identical),
   its float32 gradient micro-step through the split-TF32 kernels within
   1e-4 of the dense path; remat ``none``/``dots``/``full`` on the dense
   LM under dropout 0.1 (equal first losses, falling peak memory, the
   forward relaunched by the recompute, float32 gradients within 1e-4);
   fused projections against their split trees (float32 logits within
   1e-4, one fit step); beam search over REST (1 beam equals greedy, 4
   beams score at least greedy's log-prob); the trained MoE LM on a slot
   and a paged session (8 forward launches a prefill; agreement with
   solo recorded: capacity makes lanes compete, as in the JAX package);
   and a retired paged lane whose column lies past the step's page
   slice, which must append to the trash page without a device assert.
8. Serving plane (the ``servingPlane`` line, last): the train phase's LM
   served in float32 with speculative decoding, disaggregated prefill and
   decode, and the classifier phase's TextClassifier bucketed. A draft
   LM (vocab 32000, d_model 256, 2 layers, 4 heads over 2, window 1024)
   is fitted in bf16 on the train phase's windows (the sm90 kernels,
   2 layers x steps of each, nothing else) until its loss is below the
   target's epoch 2 or for 8 steps. Prompts of 1100-1500 successor
   tokens and one of 1200 random ids, 32 greedy tokens each, 4 slots,
   16-token pages: (a) the target as its own draft, specK 4, every
   stream equal to solo ``generate`` (acceptance against its
   end-of-stream bound recorded); (b) ``disagg: true`` with the small
   draft, every stream equal to solo, mode colocated, a handoff a
   request, an empty queue, the roles prefill/decode/draft, exactly 8
   flash_fwd_tf32x3 launches a target prefill and 2 a draft prefill and
   none in a verify or propose step, the pool back to the prefix cache's
   holds after delete (TTFT, decode tokens/s against a plain paged
   session and the draft's ms a round recorded); (c) the
   ``kv_page_handoff`` fault: one 429 without a leaked page, and latched,
   three 429s, a collapse to fused serving whose tokens equal solo; (d)
   two streams decoding while two 1500-token prompts arrive, fused and
   disaggregated: the gaps between their tokens recorded, every token
   equal to solo; (e) int8 KV with the self-draft: every request 200,
   agreement recorded; (f) ``type: "predict"`` of the classifier: bursts
   of 1, 3 and 5 rows in buckets 1, 4 and 8 and three concurrent
   clients, each row within 1e-5 of a direct ``predict`` of its padded
   bucket, 4 layers x predict calls of flash_fwd_sm90 and nothing else.
9. The keras path (the ``neural`` line, after the serving plane):
   ``NeuralModel`` at the published widths with data from seeds, bf16.
   (a) The tutorial's MNIST CNN (``docs/TUTORIAL.md`` workflow 2: conv
   32 3x3, max pool, dense 128, dense 10) fitted directly on 60000 rows
   of 784 pixels (class templates plus noise), batch 256, 2 epochs: the
   loss falls, accuracy well above chance; step ms, samples/s and a
   profiled window's idle share; one float32 step on the card within
   1e-4 (loss and each gradient's relative L2) of the same step on the
   CPU. (b) Workflow 2 over HTTP: pixels and labels of 1024 rows as two
   CSVs, ``/model``, ``/train`` with ``"checkpoint": true`` (its epoch
   losses within 1e-5 relative of a direct fit's on the same rows, bit
   equality recorded), ``/evaluate``, ``/predict`` (rows sum to 1), and
   a 1-epoch fit PATCHed to 2 that restores its step and trains epoch 2
   as the uninterrupted fit does. (c) Workflow 3's LSTM (embedding
   20000/128, lstm 128, dense 2) on 25000 rows of 200 ids, batch 128, 1
   epoch: the loss falls; the RNN route and the kernels it ran; float32
   steps of ``gru`` and ``bidirectional_lstm`` bodies within 1e-4 of the
   CPU. (d) ResNet-50 (1000 classes, 224x224x3, a softmax output
   activation as keras's), batch 64, 8 steps: a
   finite loss, every batch statistic moved, ``predict`` rows summing to
   1; step ms, images/s, peak memory. (e) The tune route: a
   ``GridSearch`` over (b)'s CNN (``learning_rate`` 1e-3/3e-4 x
   ``batch_size`` 128/256, 1 epoch) through ``/model`` and ``/tune``: 4
   trials and a refit, ``sweepFusion`` in the metadata, each trial's card
   memory freed before the next starts (what is live at a trial's start
   varies by at most 1 MiB) and its peak flat across trials of one batch
   size (within 10%); then
   a ``RandomSearch`` of 2 points over the tutorial TextClassifier
   (flash, bf16) on 1024 rows of 512 tokens: each sm90 kernel launched
   exactly 4 layers x the optimizer steps of the trials and the refit,
   the forward once more a layer for each evaluate batch, nothing else.
10. The reference's tensorflow.keras contract (the ``keras`` line): (a)
   the tutorial CNN at full width over HTTP as the reference writes it,
   ``tensorflow.keras.models`` / ``Sequential`` with six
   ``#tensorflow.keras.layers`` strings, ``compile`` with
   ``#tensorflow.keras.optimizers.Adam(1e-3)``, ``fit`` (60000
   MNIST-shaped rows, 2 epochs, batch 256) and ``evaluate``: the loss
   falls, accuracy above 0.5, epoch losses within 1e-5 relative of a
   direct ``NeuralModel`` fit from the same init and batches (bit
   equality and the ``#`` passes' child seconds recorded); (b) each
   committed SavedModel fixture (tests/fixtures/keras) through
   ``load_model`` and ``/predict`` in float32 within 1e-4 of
   TensorFlow's predictions; (c) whether h5py and keras import, then the
   ``.keras`` and legacy ``.h5`` fixtures within the same bound and a
   ``save_keras`` -> ``from_keras`` round trip within 1e-6, or each
   call's ``ImportError`` naming the missing module; (d) BASELINE config
   5 in the reference's form: ResNet-50 (1000 classes, 224x224x3) fitted
   2 steps and exported with ``save_weights``, created through
   ``tensorflow.keras.applications`` / ``ResNet50`` with that file
   (predictions within 1e-6 of the exporter's) and swept by a
   ``GridSearch`` of two learning rates on ``/tune``, card memory at each
   trial's start within 1 MiB; (e) no flash kernel launches.
11. The function route (the ``function`` line): the port's REST
   server on the card driven over HTTP by the port's own
   ``client.Context``, user code in the default ``subprocess`` sandbox.
   A probe function reports what the jailed child can import (pandas,
   sklearn) and that it sees no card (``torch.cuda.is_available()``
   false). (a) Workflow 2 as written: a 1024-row, 785-column
   MNIST-shaped CSV through ``dataset_csv.insert``, the tutorial's
   ``mnist_arrays`` body (a numpy body over the ``Table`` where the child
   has no pandas; the line says which ran), whose arrays must equal the
   CSV's pixels / 255 exactly, then the CNN's ``/model``, ``/train``
   (4 epochs, batch 256, ``"checkpoint": true``) and ``/evaluate``: the
   epoch losses within 1e-5 relative of a direct ``NeuralModel.fit`` on
   the function's arrays (bit equality recorded). (c) The jail: an
   ``open('/etc/passwd')`` body is a 406 at submit with its findings and
   leaves no collection; a dunder smuggled by a name built at run time
   fails its job with the sandbox's ``AttributeError``. (b) Workflow 3
   after (c): an ``imdb_tokens`` step writes 1024 rows of 200 ids below
   20000 for the tutorial's LSTM (3 epochs, batch 128: finite losses),
   then, PATCHed, 512 ids for the tutorial's ``TextClassifier`` (flash,
   bf16), fitted over REST with ``"batch_size": "#2 ** 7"`` for 1 epoch
   and evaluated at batch 128: exactly 4 layers x 8 steps of dq and dK/dV
   and 4 x (8 + 8) of the forward, all sm90, nothing else; the epoch loss
   within 1e-5 relative of a direct fit's, the evaluate loss below the
   untrained model's. (d) Workflow 1 where the child can import sklearn
   and pandas (else ``"sklearn": "absent"``): the Titanic-shaped CSV, the
   tutorial's ``titanic_prep``, the LogisticRegression fit and a
   ``score`` in (0.5, 1]. (e) Recorded with no limit: each function
   job's POST-to-finished seconds and the share an empty job's (the
   child's spawn) takes of it, ``ctx.wait``'s latency after ``finished``
   flips, and the phase's seconds.
12. The explore and transform routes (the ``transform`` line; BASELINE
   config 3, IMDb -> Transform -> LSTM): 4096 IMDb-shaped rows (200 ids
   below 20000 and a label, from a seed) as a CSV whose id columns are
   written as integral floats (``12.0``) beside a text column, over HTTP
   through the port's client: ``transform/dataType`` to number (the ids
   come back as the ints written), ``transform/projection`` to the ids
   and to the label (equal to the CSV's), ``explore/histogram`` of the
   label (the counts of ``numpy.unique``), the tutorial LSTM's ``/train``
   on ``$ids``/``$lab`` (1 epoch, batch 128: losses within 1e-5 relative
   of a direct fit, bit equality recorded) and ``/evaluate``; an explore
   plot (a PNG, or where the machine lacks matplotlib an ``ImportError``
   job; the line says which); the GET cache must hit.
13. The Builder (the ``builder`` line, before ``lifecycle``), over HTTP
   through the port's client: (a) the tutorial's section 6, a
   Titanic-shaped CSV (891 rows) and tests/test_server.py's modelingCode
   through LR, NB, DT, RF and GB with ``meshParallel``: LR and NB
   finish with ``engine: "torch"`` and accuracy above 0.6, fitted by
   estimators on the card under the card lease (card memory rises in the
   job; after it, card memory less the device arena's resident bytes is
   back within 1 MiB, and within 1 MiB once the arena is cleared), and
   DT, RF and GB finish on the host (``engine: "host"``, the port's own
   trees: no sklearn) with accuracy above 0.6; (a') the same body without
   ``meshParallel`` (the reference's own): all five finish on the host,
   each output with its ``prediction`` column, and the DT, RF and GB
   predictions of both bodies equal the trees' plain Python versions' on
   the same rows and seed (``LO_NATIVE=0``); the jobs ran the tree core's
   native path only, and no ``sklearn`` module was loaded; (b) LR
   and NB on 125,000 rows of 16 float32 features and 4 classes written
   through the catalog writer, fitted on the card with ``meshParallel``
   and held to the port's CPU fit of the same rows: LR's ``w`` and ``b``
   centred over the classes within 1e-2 of the largest ``|w|`` and
   >= 99.5% of the predictions equal, NB's ``theta_`` and ``var_``
   within 1e-5 relative and every prediction equal, each fit's seconds
   on both; (c) BASELINE config 4 is the ``ingest`` line's (below);
   (d) the model preflight: a ``NeuralModel`` stack that cannot build on
   its declared input is a 406 with ``shape-mismatch`` and leaves no
   collection, a good one is a 201 whose ``/train`` document carries the
   heuristic ``footprint``; (e) no flash kernel launches in the phase;
   (f) the streaming Builder (LR, NB, DT, RF) over the first 50,000 rows
   of config 4's generator (100,000 test and evaluation rows): each
   finishes with accuracy above 0.9 and its ``fitTime`` on the line, LR's
   epoch in the SGD core's native path, its predictions equal to its
   plain Python version's on the same batch.
14. The job lifecycle (the ``lifecycle`` line, before ``observe``): the tutorial LM's
   bf16 fit over REST cancelled after its first step (ended
   ``cancelled`` within 2 steps' time plus 0.5 s) and one with ``"timeout":
   2`` (``timedOut``); the card memory less the device arena's at the
   start of the job queued behind each within 1 MiB of before the fit
   (and within 1 MiB once the arena is cleared), the sm90 counters still
   after; the health sentinel on the tutorial CNN under
   ``engine_step:1:nan`` (``skip``: finite losses, a counted step;
   ``rollback`` with a checkpoint: within 1e-5 of a clean run; ``fail``:
   ``NumericalDivergence``, then ``deadLettered``) and the step ms with
   ``skip`` and without a policy; a server process killed with SIGKILL
   after a checkpointed fit's first epoch and restarted: the fit resumes,
   its epoch 2 bit-equal to an uninterrupted fit's, exactly 64 launches
   of each sm90 kernel in the restarted process and nothing else, an
   unfinished projection failed with ``InterruptedError``; the gateway's
   504 at ``LO_REQUEST_TIMEOUT`` 0.5 on a slow read whose dispatch runs
   on to its end.
15. The observability plane (the ``observe`` line), through the
   REST routes: (a) a checkpointed REST ``/train`` of the tutorial LM in
   bf16 (the training path's 8 steps): the span tree (``submit`` over
   ``validate`` and ``preflight``; ``job`` over ``queueWait``,
   ``leaseWait`` and ``attempt``, which holds ``dataLoad``, two
   ``epoch``, two ``checkpointCommit`` and ``artifactSave``), two
   timeline windows with the roofline fields, the perf report matched to
   the H100 row (989.4 TFLOP/s), ``mfu`` in [0.02, 0.10], the FLOPs a
   step the window implies at least the analytic floor, and exactly the
   pipeline fit's 128 launches of each sm90 kernel; (c) during that fit,
   with a float32 slot session resident, the memory report lists
   ``train-state``, ``serving-params`` and ``kv-cache`` against the torch
   allocator's bytes in use (the unattributed share recorded); (d) under
   ``serving_step`` latency faults, ``servingP99`` (50 ms, windows 1 s
   and 2 s) pages, ``/healthz`` answers 503, a bundle with every section
   (a 1 s torch-profiler window among them) and no collector error
   downloads as a tar, and once the fault clears the alert resolves and
   ``/healthz`` answers 200; (e) ``POST /profile`` around two predicts:
   the Chrome trace holds ``flash_fwd_tf32x3`` kernel events; (b)
   ``/metrics`` as JSON and Prometheus text carries the roofline gauges,
   the latency histograms and the gateway's series; (f) the bf16 fit's
   median step with ``LO_TRACE``, ``LO_PERF``, ``LO_XRAY`` and
   ``LO_MONITOR`` all on (a 1 s tick) within 3% of all off, in 8 job
   windows of 2 epochs of 8 steps (on, off, off, on, ...) after a fit of
   first use, and the tutorial CNN's ratio recorded.
16. Checkpoints off the training thread (the ``ckptAsync`` line, right
   after the pipeline): the pipeline's checkpointed REST fit under
   ``LO_CKPT_ASYNC=1`` equal to the synchronous one bit for bit (losses,
   each step's payload sha256 and bytes, 128 launches of each sm90
   kernel), the snapshot and commit seconds beside the synchronous
   commit's, an async resume, the ``ckpt_async_commit`` fault failing its
   job with ``AsyncCheckpointError``, a ``shards=4`` round trip and a
   resume under another optimizer kind (params-only migration).
17. Sweep fusion (the ``fusion`` line, after ``keras``): workflow 2's CNN
   GridSearch over REST, BASELINE config 5's ResNet-50 sweep and the IMDb
   LSTM's, each fused (``fallbackTrials`` 0, on the card) and unfused,
   each point within 1e-4, the kernels an optimizer step fused and
   unfused, an early stop, ``/metrics`` ``sweepFusion``, the card's
   memory flat after each cohort.
18. The feature plane (the ``featurePlane`` line, last): (a) the train
   phase's bf16 fit of the tutorial LM staged (its padded epoch on the
   card once, each step's rows gathered there) and through the prefetch
   feed (``LO_SCAN_FIT_MAX_BYTES=0``: pinned host buffers copied on a
   side stream), losses equal bit for bit, and equal to the train
   phase's, and 128 launches of each sm90 kernel each, nothing else; (b)
   the tutorial CNN at MNIST's shapes through those two feeds and a copy
   in each step (``LO_PREFETCH_BUFFER=0`` too), losses within 1e-5
   relative (bit equality recorded), each with its step ms (samples/s)
   and the idle share of a profiled epoch; ResNet-50 at batch 64 through
   the three feeds, each twice, ms a step of each; (c)
   Builder LR with ``meshParallel`` on 25,000 x 16 rows twice: the
   second run hits the device arena and the feature cache for both
   datasets, reads no table from the catalog and predicts the same; a
   write to the training dataset, then a run that misses, stages again
   and drops the old entry's bytes (cold and warm ``fitTime``); (d)
   ``$corpus`` read twice through the resolver, the second a host-tier
   hit (seconds of both); (f) a slot session's params pinned in the
   arena under X-ray ``serving-params`` and not ``arena``, back out after
   the delete; (h) ``/metrics``' ``featureCache`` and ``arena`` blocks
   and their series, moved by exactly those counts; (e) a tokened staged
   fit cancelled mid-epoch leaves no pin, and a second staged copy
   evicts it; (g) a child process with ``LO_LOCK_WITNESS=1`` (count
   mode) runs (a)'s REST fit (the same losses) and a serving round with
   no lock-order violation (its edge count recorded).
19. BASELINE config 4 as a CSV (the ``ingest`` line, after ``builder``):
   (a) ``b4train`` (10,000,000 rows), ``b4test`` and ``b4eval`` (100,000
   each) written as CSV files (five normal features from seeds 21/22/23
   rounded to six decimals as fixed-point text, the label the sign of
   the rounded margin) and ingested by ``POST /dataset/csv``: every row
   through the port's C++ CSV core (no row on the Python path, no build
   error), five float64 columns and an int64 label bit-equal to the
   values written, ingest seconds, rows/s and MB/s, and the resident
   set's growth over the ingest under 1 GiB; (b) ``streaming`` GB on
   the first 500,000 ingested rows, ``b4test`` and ``b4eval``: every
   row trained (``trainedRows``, ``trainedOnSample`` false) through the
   built C++ booster, accuracy above 0.95, the job's ``tracemalloc``
   peak under 1 GiB, ``fitTime``; (c) the first 200,000
   rows through the core and through the Python path (``LO_NATIVE=0``):
   equal stored columns, µs a row each; a rare-match query GET over the
   10M rows equal to numpy's page of the written values, with the
   per-row loop's seconds on the head; (d) the label's histogram over
   10M rows equal to ``numpy.unique``'s counts, both paths' seconds on
   the head; (e) ``gather_rows`` bit-equal to fancy indexing on a
   float32 matrix of ResNet-50's input width; no flash kernel launches.
20. The card's fair lease (the ``scheduler`` line, after ``lifecycle``),
   over REST: (a) a 3-epoch bf16 fit of the tutorial LM in pool
   ``train`` yields at an epoch boundary to an ``evaluate`` posted after
   its first epoch, which finishes first; the fit's ``leaseYields`` >=
   1, ``preemptedSeconds`` > 0, its losses bit-equal to an unyielded fit
   of the same seed and data; ``meshScheduler`` and
   ``meshSecondsByPool`` name both pools; (b) the yielded fit's bytes
   stay on the card while the evaluate runs (``memory_allocated`` at
   the yield and in the evaluate); (c) a float32 slot session serving
   ``PROMPT_LENS`` prompts yields to 1-epoch fits, mid-stream and idle,
   every token equal to solo ``generate``, its yields equal to
   ``lo_serving_lease_yields_total``, each round's TTFT; (d) under
   ``LO_SERVE_LEASE_POLICY=hold`` a fit waits until the session is
   deleted; (e) under ``LO_MESH_YIELD=0`` the fit never yields and the
   evaluate waits for its end; exact launches of the path.
21. The process group (the ``distributed`` line, last): (a) a world of
   one on NCCL (``all_reduce``, ``broadcast``, ``barrier`` on CUDA
   tensors); (b) four gloo ranks sharing the card: ring and Ulysses
   attention at the training shape against the whole-sequence kernel
   (float32 within relative L2 1e-4; bf16 recorded), exact launches per
   rank, the bytes staged through the host, and the tutorial LM's
   sharded float32 first step at dp=2, sp=2 ring and sp=2 Ulysses
   against the one-rank step (1e-4); (c) two pods of two entry points
   under ``learningorchestra_tpu_torch.cluster``'s supervisor: REST fits
   at ``LO_MESH_SHAPE=dp=2`` and, ring then Ulysses, at ``sp=2``, losses
   within 1% of the one-rank fit, each rank's launches exact; (d) a
   member SIGKILLed mid-fit: ``WorkerLost`` and ``podFailure`` within the
   heartbeat bound, then the supervisor's restart; (e) in (b)'s ranks,
   the tutorial LM's float32 first step at ``tp=2``, ``fsdp=2,tp=2`` and
   ``dp=2,tp=2``, and its MoE's at ``ep=2,tp=2`` and ``dp=2``: every
   gradient within 1e-4 of the one-rank step, each rank's params and
   AdamW moments exactly the shards its layout gives it, launches
   exact; (f) in
   the same ranks, the pipelined LM at full width, GPipe and 1F1B at
   ``pp=2`` and ``pp=4``: loss and gradients within 1e-4 of the one-rank
   sequential step, each stage's launches exact; (g) a third pod at
   ``LO_MESH_SHAPE=tp=2``: a REST fit within 1% of the one-rank fit,
   launches exact, its artifact the whole flax tree. Launches of the
   pods' fits (summed over ranks) are the ``distributed`` path; they
   run in other processes, whose epoch records report them.

The kernel launch counts are zeroed just before each path and read
just after it. ``python3 chip_smoke.py --only neural`` (or ``--only
keras``, ``--only fusion``, ``--only ckptAsync``, ``--only function``,
``--only transform``, ``--only builder``, ``--only ingest``, ``--only
lifecycle``, ``--only scheduler``, ``--only observe``, ``--only
featurePlane``, ``--only distributed``, or several,
comma-separated)
builds the kernels
and runs that phase alone (to iterate on it), printing its line and no
result line.

Earlier lines print the card (nvidia-smi name and power limit), the
build time, ptxas's registers and spill bytes of every kernel variant
(a tensor-core variant, sm90 or tf32x3, that spills fails the run),
the ``kernels`` JSON
line and the phases' lines; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises and
the exit code is not 0. Without a card, or without the package beside
it, the script exits 2 and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request

PREFIX = "/api/learningOrchestra/v1"
# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, bf16 and TF32 on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
LM_CONFIG = dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=8,
                 n_kv_heads=4, d_ff=0, max_len=2048, sliding_window=1024,
                 rope_base=10000.0)
PROMPT_LENS = (1100, 1234, 1367, 1500)
NEW_TOKENS = 32
# a small LM whose head_dim (96 / 8 = 12) is not a multiple of 8: both
# passes run the split-TF32 kernels' width-16 variants, in either dtype
D12_CONFIG = dict(LM_CONFIG, d_model=96, n_layers=2)
# the training path: 64 windows of 2048 tokens, batch 16, 2 epochs,
# grad_accum 2 -> 8 optimizer steps of 2 micro-batches
TRAIN_WINDOWS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_ACCUM = \
    64, 2048, 16, 2, 2
# each kernel (one per CUDA source) and the counter its wrapper adds one
# to at each launch
COUNTERS = {"flash_fwd_sm90": "FLASH_FWD_SM90_LAUNCHES",
            "flash_bwd_dq_sm90": "FLASH_BWD_DQ_SM90_LAUNCHES",
            "flash_bwd_dkv_sm90": "FLASH_BWD_DKV_SM90_LAUNCHES",
            "flash_fwd_tf32x3": "FLASH_FWD_TF32X3_LAUNCHES",
            "flash_bwd_dq_tf32x3": "FLASH_BWD_DQ_TF32X3_LAUNCHES",
            "flash_bwd_dkv_tf32x3": "FLASH_BWD_DKV_TF32X3_LAUNCHES"}
# the tutorial's LoRA fine-tune: rank 16 on a second corpus of 64 windows,
# batch 16, 2 epochs (8 optimizer steps, no accumulation)
LORA_RANK, LORA_BATCH, LORA_EPOCHS = 16, 16, 2
# the tutorial's sampled generate on the merged model
TUTORIAL_GENERATE = {"prompt": [[101, 2023, 2003]], "max_new_tokens": 64,
                     "temperature": 0.8, "top_p": 0.9}
# the tutorial's TextClassifier (head_dim 32: the sm90 kernels, non-causal)
CLF_CONFIG = dict(vocab_size=20000, n_classes=2, d_model=256, n_layers=4,
                  n_heads=8, n_kv_heads=4, max_len=512)
# 1024 rows of 512 tokens, batch 128, 3 epochs -> 24 optimizer steps
CLF_ROWS, CLF_SEQ, CLF_BATCH, CLF_EPOCHS = 1024, 512, 128, 3
# epoch losses of the train phase's fit through the first, CUDA-core
# kernels (bf16; PERF.md), which the tensor-core route must stay within
# 1% of
CUDA_CORE_LOSSES = (8.82798957824707, 3.2666094303131104)


def _reset_launches(attn) -> None:
    for counter in COUNTERS.values():
        setattr(attn, counter, 0)


def _launches(attn) -> dict:
    """Launches of each kernel (one per CUDA source) since the reset."""
    return {name: getattr(attn, counter)
            for name, counter in COUNTERS.items()}


def _kernel_name(mangled: str) -> str:
    """``flash_bwd_dq_tf32x3_kernel<bf16,16,0>`` from ptxas's mangled
    name (types, ints, and bools as 0 or 1)."""
    m = re.search(r"(?<=\d)(flash_\w*?_kernel)I(.+?)EEv", mangled)
    if not m:
        # a kernel that is no template: its name alone
        m = re.search(r"(?<=\d)(flash_\w*?_kernel)E", mangled)
        return m.group(1) if m else mangled
    args = [n or b or ("bf16" if bf else "float") for n, b, bf, _ in
            re.findall(r"Li(\d+)E|Lb(\d)|(13__nv_bfloat16)|(f)",
                       m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def _ptxas_report(log: str) -> list:
    """Registers, stack frame and spill bytes of each kernel variant in
    ``nvcc -Xptxas=-v`` output."""
    out = []
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            out.append({"kernel": _kernel_name(m.group(1))})
        elif out and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", line)):
            out[-1].update(stackFrame=int(m.group(1)),
                           spillStores=int(m.group(2)),
                           spillLoads=int(m.group(3)))
        elif out and (m := re.search(r"Used (\d+) registers", line)):
            out[-1]["registers"] = int(m.group(1))
    return out


def _time_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _sm_clock_mhz() -> dict:
    """The card's SM clock now and at most, in MHz, as nvidia-smi reads
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split("\n")[0].split(",")
    return {"smClockMhz": float(out[0]), "smClockMaxMhz": float(out[1])}


# special-function-unit exponentials an SM issues a clock (16 on Hopper)
# and the H100 SXM's SMs
MUFU_PER_SM_CLOCK, SMS = 16, 132


def _exp_bound_ms(pairs: int, clock_mhz: float) -> float:
    """The least time for one exp2 a visible pair on the card's
    special-function units at ``clock_mhz``."""
    return pairs / (MUFU_PER_SM_CLOCK * SMS * clock_mhz * 1e6) * 1e3


def _sdpa_times(torch, q, k, v, do, causal, window, offset, scale):
    """SDPA on the same inputs under each backend that takes the call
    (flash, efficient, cuDNN, math): with the boolean mask of the visible
    pairs, and where every pair is visible also with ``attn_mask=None``.
    Its forward, and with ``do`` its backward as forward + backward less
    forward. Returns ``{"figures": {backend/mask: {forwardMs[,
    backwardMs]} or {error}}, "forwardBackend", "forwardMs"[,
    "backwardBackend", "backwardMs"]}``, the fastest of each. The
    efficient backend takes no grouped-query call, so for one the
    figures also hold ``efficient/expanded/<mask>``: the call on K/V
    repeated to q's heads, the repeat timed inside the figure; it is two
    calls, and never the fastest."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    mask = _visible_mask(torch, q.shape[1], k.shape[1], causal, window,
                         offset, q.device)
    masks = {"mask": mask}
    if bool(mask.all()):
        masks["none"] = None
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(
        do is not None) for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous() if do is not None else None
    group = q.shape[2] // k.shape[2]

    def call(m, expand=False):
        if expand:
            return F.scaled_dot_product_attention(
                qt, kt.repeat_interleave(group, dim=1),
                vt.repeat_interleave(group, dim=1), attn_mask=m,
                scale=scale)
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=m, scale=scale, enable_gqa=True)

    runs = [(f"{name}/{mask_name}", backend, m, False)
            for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                                  ("efficient",
                                   SDPBackend.EFFICIENT_ATTENTION),
                                  ("cudnn", SDPBackend.CUDNN_ATTENTION),
                                  ("math", SDPBackend.MATH))
            for mask_name, m in masks.items()]
    if group > 1:
        runs += [(f"efficient/expanded/{mask_name}",
                  SDPBackend.EFFICIENT_ATTENTION, m, True)
                 for mask_name, m in masks.items()]
    figures = {}
    for key, backend, m, expand in runs:
        def fwd(m=m, expand=expand):
            return call(m, expand)

        def fwd_bwd():
            torch.autograd.grad(fwd(), (qt, kt, vt), dot)

        try:
            with sdpa_kernel([backend]):
                with torch.no_grad():
                    figures[key] = {"forwardMs": _time_ms(torch, fwd)}
                if do is not None:
                    figures[key]["backwardMs"] = _time_ms(
                        torch, fwd_bwd) - figures[key]["forwardMs"]
        except RuntimeError as exc:
            figures[key] = {"error": str(exc).splitlines()[0][:160]}
    out = {"figures": figures}
    for part in ("forward", "backward"):
        ran = {k: f[f"{part}Ms"] for k, f in figures.items()
               if f"{part}Ms" in f and "/expanded/" not in k}
        if part == "backward" and do is None:
            break
        if not ran:
            raise AssertionError(f"no SDPA backend took the call: {figures}")
        fastest = min(ran, key=ran.get)
        out.update({f"{part}Backend": fastest, f"{part}Ms": ran[fastest]})
    del qt, kt, vt, dot, mask
    return out


def _visible_mask(torch, sq, sk, causal, window, offset, device):
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= row >= col + offset
    if window > 0:
        mask &= col + offset > row - window
    return mask


def _split_fwd(torch, attn, q, k, v, causal, scale, window, offset):
    """The plain forward with the weights exp(s - m) split into bf16 hi
    + lo before the product with v, as flash_fwd_sm90 multiplies them,
    and each element's bound term sum_j p_j |v_j| / l. float32, (b, sq,
    h, d) each."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    valid = attn._visible(sq, sk, causal, window, offset, q.device)
    s = torch.where(valid, s, attn.NEG_INF)
    e = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    del s
    l = e.sum(dim=-1, keepdim=True)
    inv = torch.where(l > 0, 1.0 / l, 0.0).permute(0, 3, 1, 2, 4)
    o = torch.einsum("bhgqk,bkhd->bqhgd", attn._bf16_split(e), v.float())
    w = torch.einsum("bhgqk,bkhd->bqhgd", e, v.float().abs())
    return (o * inv).reshape(b, sq, h, d), (w * inv).reshape(b, sq, h, d)


def _sm90_fwd_used(torch, attn, o, ro, q, k, v, causal, scale, window,
                   offset):
    """The shares of its two bounds a wgmma forward's bf16 ``o`` uses
    (each <= 1 passes): (a) against the float32 plain version ``ro`` at
    the derived bound of bf16 P, 2**-8 sum p |v| / l, plus o's own
    rounding (one bf16 ulp, <= 2**-7 |ro|); (b) against the plain version
    with P split as the kernel splits it: float32 order (2**-14 of the
    bound term) plus o's rounding."""
    eo, w = _split_fwd(torch, attn, q, k, v, causal, scale, window, offset)
    used_a = ((o.float() - ro.float()).abs()
              / (2.0 ** -8 * w + 2.0 ** -7 * ro.float().abs() + 1e-5)) \
        .max().item()
    eo = eo.to(o.dtype).float()
    used_b = ((o.float() - eo).abs()
              / (2.0 ** -14 * w + 2.0 ** -7 * eo.abs() + 1e-6)).max().item()
    return used_a, used_b


def _split_bwd(torch, attn, q, k, v, o, lse, do, dlse, causal, scale,
               window, offset):
    """flash_bwd_reference's dQ, dK and dV with P and dS split into bf16
    hi + lo before the products, as flash_bwd_dq_sm90 and
    flash_bwd_dkv_sm90 multiply them, and each element's bound terms
    sum |ds| |k|, sum |ds| |q| and sum p |dO|. float32."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    dog = do.float().reshape(b, sq, kvh, h // kvh, d)
    valid = attn._visible(sq, sk, causal, window, offset, q.device)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    p = torch.exp(torch.where(valid, s - attn._by_group(lse.float(), kvh),
                              attn.NEG_INF))
    del s
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - attn._by_group(attn._bwd_delta(o, do, dlse), kvh)) \
        * scale
    del dp
    ds_split = attn._bf16_split(ds)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds_split, k.float()) \
        .reshape(b, sq, h, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds_split, qg)
    del ds_split
    dv = torch.einsum("bhgqk,bqhgd->bkhd", attn._bf16_split(p), dog)
    bq = torch.einsum("bhgqk,bkhd->bqhgd", ds.abs(), k.float().abs()) \
        .reshape(b, sq, h, d)
    bk = torch.einsum("bhgqk,bqhgd->bkhd", ds.abs(), qg.abs())
    bv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog.abs())
    return dq, dk, dv, bq, bk, bv


def kernel_phase(torch, log):
    """The forward kernels against flash_attention_reference on the card,
    by route (:func:`_route`): flash_fwd_sm90 (bf16 at a head_dim that is
    a multiple of 8, wgmma tensor cores) and flash_fwd_tf32x3 (every
    other float32 or bf16 head_dim, split-TF32 tensor cores). Returns the
    kernels-line entries: flash_fwd_tf32x3 at the slice's shape (its main
    path, serving) with its training-shape and d-12 numbers nested,
    flash_fwd_sm90 at the training path's bf16 shape."""
    from learningorchestra_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    # (name, b, sq, sk, h, kvh, d, causal, window, kv_offset, dtype)
    cases = [
        ("slice", 1, 1536, 1536, 8, 4, 64, True, 1024, 0, f32),
        ("slice", 1, 1536, 1536, 8, 4, 64, True, 1024, 0, bf16),
        # a main-path prompt length: the last q tile is ragged
        ("prefill-1500", 1, 1500, 1500, 8, 4, 64, True, 1024, 0, f32),
        ("prefill-1500", 1, 1500, 1500, 8, 4, 64, True, 1024, 0, bf16),
        ("non-causal", 2, 96, 96, 4, 2, 64, False, 0, 0, f32),
        ("non-causal", 2, 96, 96, 4, 2, 64, False, 0, 0, bf16),
        ("mqa", 2, 130, 130, 8, 1, 64, True, 0, 0, f32),
        ("mqa", 2, 130, 130, 8, 1, 64, True, 0, 0, bf16),
        ("ragged-sk", 2, 77, 201, 4, 2, 32, False, 0, 0, f32),
        ("ragged-sk", 2, 77, 201, 4, 2, 32, False, 0, 0, bf16),
        ("offset-empty-rows", 2, 64, 64, 4, 4, 128, True, 16, 40, f32),
        ("offset-empty-rows", 2, 64, 64, 4, 4, 128, True, 16, 40, bf16),
        ("offset-empty-rows", 1, 64, 64, 4, 4, 64, True, 16, 40, bf16),
        ("offset-empty-rows", 1, 64, 64, 4, 4, 64, True, 16, 40, f32),
        # the training path's shape: bf16 is its dtype, float32 the
        # float32 fit's
        ("train", 8, 2048, 2048, 8, 4, 64, True, 1024, 0, bf16),
        ("train", 8, 2048, 2048, 8, 4, 64, True, 1024, 0, f32),
        # the d-12 LM's micro-step (2 windows of 2048): the split-TF32
        # kernel's width-16 variant in both dtypes
        ("lm-d12", 2, 2048, 2048, 8, 4, 12, True, 1024, 0, f32),
        ("lm-d12", 2, 2048, 2048, 8, 4, 12, True, 1024, 0, bf16),
        # an odd head_dim (a bf16 row of odd length loads element by
        # element; o's last pair is a single column) with ragged sq and
        # sk, and a kv_offset that leaves rows with no visible key; every
        # head its own kv head, so o and lse are compared on every head
        ("ragged-offset-empty-rows-d13", 2, 75, 131, 4, 4, 13, True, 16,
         40, f32),
        ("ragged-offset-empty-rows-d13", 2, 75, 131, 4, 4, 13, True, 16,
         40, bf16),
        # a multiple of 4 but not of 8, between the kernels' widths, GQA
        ("gqa-window-d36", 2, 160, 160, 8, 2, 36, True, 48, 0, f32),
        ("gqa-window-d36", 2, 160, 160, 8, 2, 36, True, 48, 0, bf16),
        # the classifier's fit: a batch of 128 rows of 512 tokens, 8
        # heads over 4 at head_dim 32, bidirectional
        ("classifier", 128, 512, 512, 8, 4, 32, False, 0, 0, bf16),
        # the wgmma forward's narrow instance (head_dim <= 32) in bf16:
        # d 8, 16 and 24 with every head its own kv head (lse compared),
        # d 32 under causal, a window and a kv_offset that leaves rows
        # with no visible key, ragged sq and sk, MQA, and more work items
        # (16 x 8 heads x 2 q tiles of 256 rows) than the card has SMs, so
        # that a block walks several
        ("narrow-window-d8", 2, 150, 150, 4, 4, 8, True, 32, 0, bf16),
        ("narrow-causal-d16", 2, 130, 130, 4, 4, 16, True, 0, 0, bf16),
        ("narrow-d24", 2, 96, 96, 4, 4, 24, False, 0, 0, bf16),
        ("narrow-window-offset-empty-rows-d32", 2, 200, 200, 4, 4, 32,
         True, 48, 24, bf16),
        ("narrow-ragged-d24", 2, 77, 201, 4, 4, 24, False, 0, 0, bf16),
        ("narrow-mqa-d16", 2, 130, 130, 8, 1, 16, True, 0, 0, bf16),
        ("narrow-persistent-window-d32", 16, 320, 320, 8, 8, 32, True, 96,
         0, bf16),
    ]
    # (atol, rtol). float32: summation order only (the split-TF32 route's
    # products depart from float32 ones by about 2**-22 of sum |x||y|).
    # bf16: o is rounded once from float32 by kernel and plain version
    # alike, so they differ by at most one bf16 ulp of |o| (<= 2**-7 |o|,
    # under rtol) plus the float32 error (under atol); the wgmma kernel
    # adds its bf16 hi + lo split of P, about 2**-16 of the product
    tols = {f32: (2e-5, 2e-5), bf16: (1e-4, 1e-2)}
    # the counter each route's wrapper adds one to
    routed = {"sm90": "FLASH_FWD_SM90_LAUNCHES",
              "tf32x3": "FLASH_FWD_TF32X3_LAUNCHES"}
    entries = {}
    for (name, b, sq, sk, h, kvh, d, causal, window, offset,
         dtype) in cases:
        def rand(*shape):
            return torch.randn(*shape, device="cuda", generator=gen) \
                .to(dtype)

        q, k, v = rand(b, sq, h, d), rand(b, sk, kvh, d), rand(b, sk, kvh, d)
        with_lse = h == kvh
        route = attn._route(q)
        want_route = "sm90" if dtype == bf16 and d % 8 == 0 else "tf32x3"
        sm90 = route == "sm90"
        narrow = sm90 and d <= attn.NARROW_HEAD_DIM
        scale = 1.0 / d ** 0.5

        def kernel():
            if with_lse:
                return attn.flash_attention_with_lse(
                    q, k, v, causal=causal, window=window, kv_offset=offset)
            return attn.flash_attention(q, k, v, causal=causal,
                                        window=window), None

        def plain(split=False):
            return attn.flash_attention_reference(
                q, k, v, causal=causal, window=window, kv_offset=offset,
                tf32x3=split)

        before = {r: getattr(attn, c) for r, c in routed.items()}
        o, lse = kernel()
        torch.cuda.synchronize()
        ran = {r: getattr(attn, c) - before[r] for r, c in routed.items()}
        if route != want_route or ran != {r: int(r == route)
                                          for r in routed}:
            raise AssertionError(f"flash_fwd {name} {dtype}: took the "
                                 f"{route} route, want {want_route} "
                                 f"(launches {ran})")
        ro, rlse = plain()
        diff = (o.float() - ro.float()).abs()
        err = diff.max().item()
        atol, rtol = tols[dtype]
        # worst |o - ro| / (atol + rtol |ro|); <= 1 passes
        excess = (diff / (atol + rtol * ro.float().abs())).max().item()
        if not excess <= 1.0:
            raise AssertionError(f"flash_fwd {name} {dtype}: |o - ro| "
                                 f"exceeds atol {atol} + rtol {rtol} |ro| "
                                 f"by {excess}x (max abs err {err})")
        line = {"case": name, "dtype": str(dtype).split(".")[-1],
                "kernel": f"flash_fwd_{route}", "narrow": narrow,
                "shape": [b, sq, sk, h, kvh, d], "causal": causal,
                "window": window, "kvOffset": offset, "maxAbsErr": err,
                "atol": atol, "rtol": rtol, "tolUsed": excess}
        if narrow:
            # deterministic: a second launch on the same inputs gives the
            # same bits (every item's sums in one fixed order, whichever
            # block of the persistent grid walks it)
            again, again_lse = kernel()
            torch.cuda.synchronize()
            line["bitEqual"] = torch.equal(again, o) and (
                lse is None or torch.equal(again_lse, lse))
            del again, again_lse
            if not line["bitEqual"]:
                raise AssertionError(f"flash_fwd_sm90 {name}: two launches "
                                     f"differ")
        if sm90:
            used_a, used_b = _sm90_fwd_used(torch, attn, o, ro, q, k, v,
                                            causal, scale, window, offset)
            if not (used_a <= 1.0 and used_b <= 1.0):
                raise AssertionError(
                    f"flash_fwd_sm90 {name}: bound used {used_a}x, "
                    f"split emulation tolerance used {used_b}x")
            line.update(derivedBoundUsed=used_a, splitEmulationUsed=used_b)
        else:
            # against the plain version that splits both products 3xTF32
            # as the kernel does, at the same tolerance
            eo, e_lse = plain(split=True)
            used = ((o.float() - eo.float()).abs()
                    / (atol + rtol * eo.float().abs())).max().item()
            seen = e_lse != attn.NEG_INF
            lse_used = ((lse - e_lse)[seen].abs().max().item() / 1e-4
                        if lse is not None else 0.0)
            del eo, e_lse
            if not (used <= 1.0 and lse_used <= 1.0):
                raise AssertionError(
                    f"flash_fwd_tf32x3 {name} {dtype}: split emulation "
                    f"tolerance used {used}x (lse {lse_used}x)")
            line["splitEmulationUsed"] = used
        empty = 0
        if lse is not None:
            # rows with no visible key carry exactly NEG_INF in both
            seen = rlse != attn.NEG_INF
            if not torch.equal(seen, lse != attn.NEG_INF):
                raise AssertionError(f"flash_fwd {name}: empty rows differ")
            lse_err = (lse - rlse)[seen].abs().max().item()
            if not lse_err <= (2e-5 if sm90 else 1e-4):
                raise AssertionError(f"flash_fwd {name}: lse err {lse_err}")
            empty = int((~seen).sum())
            if offset and not (empty and bool((o[~seen] == 0).all())):
                raise AssertionError(f"{name}: no empty rows, or empty "
                                     f"rows with a non-zero o")
            line["lseMaxAbsErr"] = lse_err
        line["emptyRows"] = empty
        if name in ("slice", "train", "lm-d12", "classifier"):
            mask = _visible_mask(torch, sq, sk, causal, window, offset,
                                 q.device)
            pairs = int(mask.sum())
            flops = 4.0 * d * pairs * h * b
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size() + 4 * b * sq * h
            dt = line["dtype"]
            # the least time for the function on these inputs, whatever
            # the route: bf16 inputs at the card's bf16 rate, float32 ones
            # as three TF32 products; float32 FMAs beside it, and the
            # split work the route runs (wgmma: P split hi + lo, 6 d FLOP
            # per pair in bf16; split TF32: 12 d in float32, 6 d in bf16,
            # whose Q.K^T is one product and P.V two, at the TF32 rate)
            fp32_ms = flops / PEAK_FLOPS["float32"] * 1e3
            op_ms = (flops / PEAK_FLOPS["bfloat16"] if dtype != f32
                     else 3 * flops / PEAK_FLOPS["tf32"]) * 1e3
            split_ms = (1.5 * flops / PEAK_FLOPS["bfloat16"] if sm90
                        else (3 if dtype == f32 else 1.5) * flops
                        / PEAK_FLOPS["tf32"]) * 1e3
            byte_ms = nbytes / PEAK_BYTES * 1e3
            # library yardstick: the fastest SDPA backend on the call
            sdpa = _sdpa_times(torch, q, k, v, None, causal, window, offset,
                               scale)
            clock = _sm_clock_mhz()
            line.update({
                "ms": _time_ms(torch, lambda: kernel()),
                "plain_ms": _time_ms(torch, plain, iters=5),
                "library_ms": sdpa["forwardMs"],
                "libraryBackend": sdpa["forwardBackend"],
                "sdpaBackends": {k: f.get("forwardMs", f.get("error"))
                                 for k, f in sdpa["figures"].items()},
                "bound_ms": max(op_ms, byte_ms),
                "bound_by": "operations" if op_ms >= byte_ms else "bytes",
                "boundFloat32Ms": fp32_ms, "boundSplitMs": split_ms,
                "boundExpMs": _exp_bound_ms(pairs * h * b,
                                            clock["smClockMaxMhz"]),
                "flops": flops, "bytes": nbytes, "visiblePairs": pairs,
                **clock,
            })
            del mask
            picked = {k: line[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "libraryBackend", "boundFloat32Ms", "boundSplitMs",
                "boundExpMs", "smClockMaxMhz", "splitEmulationUsed",
                "narrow")}
            picked.update(max_abs_err=err, dtype=dt,
                          shape=[b, sq, sk, h, kvh, d])
            if "derivedBoundUsed" in line:
                picked["derivedBoundUsed"] = line["derivedBoundUsed"]
            if name == "slice" and dtype == f32:
                entries.setdefault("flash_fwd_tf32x3", {}).update(picked)
            elif name == "train" and dtype == f32:
                entries.setdefault("flash_fwd_tf32x3", {})[
                    "trainShapeFloat32"] = picked
            elif name == "train":
                entries.setdefault("flash_fwd_sm90", {}).update(picked)
            elif name == "classifier":
                # nested, so that the training shape's figures stay the
                # entry's own
                entries.setdefault("flash_fwd_sm90", {})[
                    "classifierShape"] = picked
            elif name == "lm-d12":
                # nested, so that the serving shape's figures stay the
                # entry's own
                entries.setdefault("flash_fwd_tf32x3", {})[
                    "d12Float32" if dtype == f32 else "d12Bfloat16"] = picked
        log.append("kernel " + json.dumps(line))
        del q, k, v, o, lse, ro, rlse, diff
    return entries


def bwd_kernel_phase(torch, log):
    """The backward kernels against flash_bwd_reference on the card, each
    case in fp32 and bf16, on the forward kernel's own (o, lse), by the
    backward's route (:func:`_route`): flash_bwd_dq_sm90 and
    flash_bwd_dkv_sm90 (bf16 at a head_dim that is a multiple of 8),
    flash_bwd_dq_tf32x3 and flash_bwd_dkv_tf32x3 (every other head_dim,
    float32 or bf16). Returns the kernels-line entries: each kernel at
    the training path's shape in its dtype, bf16 for the fit and float32
    for the float32 fit, with the tf32x3 kernels' d-12 figures nested."""
    from learningorchestra_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(1)
    # (name, b, sq, sk, h, kvh, d, causal, window, kv_offset, dlse)
    cases = [
        ("train", 8, 2048, 2048, 8, 4, 64, True, 1024, 0, False),
        ("non-causal-ragged-d32", 2, 77, 201, 4, 2, 32, False, 0, 0, False),
        ("mqa", 2, 130, 130, 8, 1, 64, True, 0, 0, False),
        ("offset-empty-rows-dlse-d128", 2, 64, 64, 4, 4, 128, True, 16, 40,
         True),
        # the d-12 LM's micro-step (2 windows of 2048): a head_dim off the
        # multiple of 8 takes the split-TF32 backward in both dtypes
        ("lm-d12", 2, 2048, 2048, 8, 4, 12, True, 1024, 0, False),
        # an odd head_dim (a bf16 row of odd length: loads element by
        # element) with ragged sq and sk under a dlse term
        ("ragged-dlse-d13", 2, 75, 131, 4, 4, 13, False, 0, 0, True),
        # a multiple of 4 but not of 8, between the kernels' widths, GQA
        ("gqa-window-d36", 2, 160, 160, 8, 2, 36, True, 48, 0, False),
        # the wgmma kernels' narrow instances (head_dim <= 32) in bf16:
        # GQA under causal at d 16, a window, kv_offset (rows with no
        # visible key) and dlse at d 32, ragged sq and sk at d 24
        ("gqa-causal-d16", 2, 130, 130, 8, 2, 16, True, 0, 0, False),
        ("window-offset-dlse-d32", 2, 200, 200, 4, 2, 32, True, 48, 24,
         True),
        ("ragged-d24", 2, 77, 201, 4, 2, 24, False, 0, 0, False),
        # the classifier's fit (b 128, 512 tokens, d 32, bidirectional);
        # measured in bf16, its dtype
        ("classifier", 128, 512, 512, 8, 4, 32, False, 0, 0, False),
    ]
    # (atol as a share of the case's largest |g|, rtol). Kernel and plain
    # version compute in float32 from the same inputs and (o, lse) and
    # differ in summation order only. The tensor-core dQ and dK/dV are
    # held more tightly: sm90 (bf16 on wgmma) (a) to the derived bound of
    # bf16 P and dS, 2**-8 sum |ds| |k|, 2**-8 sum |ds| |q| and 2**-8 sum
    # p |dO|, and (b) to the float32 tolerance against the plain version
    # with P and dS split into bf16 hi + lo as the kernels split them;
    # tf32x3 in both dtypes (a bf16 input is exact in TF32) to the
    # float32 tolerance against the float32 plain version and against
    # the plain version that splits every product 3xTF32 as the kernels
    # do. sm90 holds bf16 to the bound a bf16 gradient would carry
    # (rtol 1e-2, about one bf16 ulp).
    tols = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 1e-2)}
    routed = {"sm90": ("FLASH_BWD_DQ_SM90_LAUNCHES",
                       "FLASH_BWD_DKV_SM90_LAUNCHES"),
              "tf32x3": ("FLASH_BWD_DQ_TF32X3_LAUNCHES",
                         "FLASH_BWD_DKV_TF32X3_LAUNCHES")}
    entries = {}
    for (name, b, sq, sk, h, kvh, d, causal, window, offset,
         with_dlse) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            def rand(*shape):
                return torch.randn(*shape, device="cuda", generator=gen) \
                    .to(dtype)

            q, k, v = rand(b, sq, h, d), rand(b, sk, kvh, d), \
                rand(b, sk, kvh, d)
            do = rand(b, sq, h, d)
            dlse = torch.randn(b, sq, h, device="cuda", generator=gen) \
                if with_dlse else None
            scale = 1.0 / d ** 0.5
            o, lse = attn._flash_fwd(q, k, v, causal, scale, window, offset)
            delta = attn._bwd_delta(o, do, dlse)
            route = attn._route(q)
            want_route = "sm90" if dtype == torch.bfloat16 and d % 8 == 0 \
                else "tf32x3"
            dq = getattr(attn, f"_flash_bwd_dq_{route}")
            dkv = getattr(attn, f"_flash_bwd_dkv_{route}")
            dq_name, dkv_name = (f"{n}_{route}" for n in (
                "flash_bwd_dq", "flash_bwd_dkv"))
            args = (q, k, v, do, lse, delta, causal, scale, window, offset)
            # the narrow wgmma instances run as the backward runs them
            # (_flash_bwd_narrow): dQ computes delta from o and dlse and
            # writes lse and delta by head, which dK/dV reads
            narrow = route == "sm90" and d <= attn.NARROW_HEAD_DIM
            by_head = tuple(torch.full((b, h, attn._head_rows(sq)),
                                       float("nan"), device="cuda")
                            for _ in range(2)) if narrow else None

            def dq_kernel():
                if narrow:
                    return dq(q, k, v, do, lse, None, causal, scale, window,
                              offset, o=o, dlse=dlse, by_head=by_head)
                return dq(*args)

            def dkv_kernel():
                if narrow:
                    return dkv(q, k, v, do, None, None, causal, scale,
                               window, offset, by_head=by_head)
                return dkv(*args)

            def plain(split=False):
                return attn.flash_bwd_reference(
                    q, k, v, o, lse, do, dlse, causal=causal, scale=scale,
                    window=window, kv_offset=offset, tf32x3=split)

            counters = [c for pair in routed.values() for c in pair]
            before = [getattr(attn, c) for c in counters]
            got = (dq_kernel(), *dkv_kernel())
            torch.cuda.synchronize()
            ran = dict(zip(counters, (getattr(attn, c) - n
                                      for c, n in zip(counters, before))))
            want_ran = {c: int(r == route) for r, pair in routed.items()
                        for c in pair}
            if ran != want_ran or route != want_route:
                raise AssertionError(f"flash_bwd {name} {dtype}: dq and "
                                     f"dkv took the {route} route, want "
                                     f"{want_route} (tensor-core launches "
                                     f"{ran})")
            want = plain()
            rel_atol, rtol = tols[torch.float32 if route == "tf32x3"
                                  else dtype]
            # each of dq, dk, dv finite and within atol (rel_atol of the
            # case's largest |g|) + rtol |g| of the float32 plain version
            errs, used = [], []
            for g, w, part in zip(got, want, ("dq", "dk", "dv")):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"flash_bwd {name} {dtype}: {part} "
                                         f"not finite")
                atol = rel_atol * w.abs().max().item()
                diff = (g - w).abs()
                errs.append(diff.max().item())
                # worst |g - w| / (atol + rtol |w|); <= 1 passes
                used.append((diff / (atol + rtol * w.abs())).max().item())
                if not used[-1] <= 1.0:
                    raise AssertionError(
                        f"flash_bwd {part} {name} {dtype}: exceeds atol "
                        f"{atol} + rtol {rtol} |ref| by {used[-1]}x (max "
                        f"abs err {errs[-1]})")
            empty = int((lse == attn.NEG_INF).sum())
            if offset and not (empty and bool(
                    (got[0][lse == attn.NEG_INF] == 0).all())):
                raise AssertionError(f"{name}: no empty rows, or empty "
                                     f"rows with a non-zero dq")
            launch_checks = {}
            if route == "sm90":
                # deterministic: a second launch of each kernel on the
                # same inputs gives the same bits
                again = (dq_kernel(), *dkv_kernel())
                torch.cuda.synchronize()
                launch_checks["bitEqual"] = all(torch.equal(a, g)
                                         for a, g in zip(again, got))
                del again
                if not launch_checks["bitEqual"]:
                    raise AssertionError(f"flash_bwd sm90 {name}: two "
                                         f"launches differ")
            if narrow:
                # lse by head exactly, delta by head at float32 order,
                # zero past sq
                rows = attn._head_rows(sq)
                want_t = (attn._by_head(lse, rows), attn._by_head(delta,
                                                                  rows))
                launch_checks["byHeadLseEqual"] = torch.equal(by_head[0],
                                                       want_t[0])
                launch_checks["byHeadDeltaUsed"] = (
                    (by_head[1] - want_t[1]).abs()
                    / (1e-5 * want_t[1].abs().max().item()
                       + 1e-5 * want_t[1].abs())).max().item()
                del want_t
                if not (launch_checks["byHeadLseEqual"]
                        and launch_checks["byHeadDeltaUsed"] <= 1.0):
                    raise AssertionError(f"flash_bwd_dq_sm90 {name}: lse "
                                         f"and delta by head {launch_checks}")
            dt = str(dtype).split(".")[-1]
            line = {"case": name, "dtype": dt, "route": route,
                    "dqKernel": dq_name, "dkvKernel": dkv_name,
                    "shape": [b, sq, sk, h, kvh, d], "causal": causal,
                    "window": window, "kvOffset": offset, "dlse": with_dlse,
                    "maxAbsErr": dict(zip(("dq", "dk", "dv"), errs)),
                    "relAtol": rel_atol, "rtol": rtol,
                    "tolUsed": dict(zip(("dq", "dk", "dv"), used)),
                    "emptyRows": empty, "narrow": narrow, **launch_checks}
            if route == "sm90":
                split = _split_bwd(torch, attn, q, k, v, o, lse, do, dlse,
                                   causal, scale, window, offset)
                checks = {}
                for part, g, w, e, bound in zip(("dq", "dk", "dv"), got,
                                                want, split[:3], split[3:]):
                    floor = 1e-4 * w.abs().max().item()
                    checks[part] = (
                        ((g - w).abs() / (2.0 ** -8 * bound + floor))
                        .max().item(),
                        ((g - e).abs() / (floor + 1e-4 * e.abs()))
                        .max().item())
                del split
                if not all(a <= 1.0 and e <= 1.0
                           for a, e in checks.values()):
                    raise AssertionError(f"flash_bwd sm90 {name}: (bound "
                                         f"used, split emulation used) "
                                         f"{checks}")
                line["derivedBoundUsed"] = {
                    k: c[0] for k, c in checks.items()}
                line["splitEmulationUsed"] = {
                    k: c[1] for k, c in checks.items()}
            else:
                checks = {}
                for part, g, w, e in zip(("dq", "dk", "dv"), got, want,
                                         plain(split=True)):
                    floor = 1e-4 * w.abs().max().item()
                    checks[part] = ((g - e).abs()
                                    / (floor + 1e-4 * e.abs())).max().item()
                if not all(e <= 1.0 for e in checks.values()):
                    raise AssertionError(f"flash_bwd tf32x3 {name}: split "
                                         f"emulation used {checks}")
                line["splitEmulationUsed"] = checks
            # figures nested under the entry, so that the training
            # shape's stay its own
            nest = {"lm-d12": "d12Float32" if dtype == torch.float32
                    else "d12Bfloat16",
                    "classifier": "classifierShape"}.get(name)
            if name == "train" or name == "lm-d12" or (
                    name == "classifier" and dtype == torch.bfloat16):
                pairs = int(_visible_mask(torch, sq, sk, causal, window,
                                          offset, q.device).sum())
                elt = q.element_size()
                ins = (2 * q.numel() + k.numel() + v.numel()) * elt \
                    + 2 * 4 * lse.numel()
                plain_ms = _time_ms(torch, plain, iters=3)
                # library yardstick: the fastest SDPA backward on the
                # same call, forward + backward less forward, under each
                # backend that takes it
                sdpa = _sdpa_times(torch, q, k, v, do, causal, window,
                                   offset, scale)
                library_ms = sdpa["backwardMs"]
                clock = _sm_clock_mhz()
                exp_ms = _exp_bound_ms(pairs * h * b, clock["smClockMaxMhz"])
                # each kernel: its launch, the function's FLOP per visible
                # pair and head-dim column, the same with bf16 inputs on
                # the tensor cores (P and dS split hi + lo, each input
                # whole: 1 + 1 + 2 products for dq, 1 + 1 + 2 + 2 for
                # dK/dV, whether as bf16 on wgmma or as TF32), output
                # elements, the gradients it writes
                for kernel, fn, per_pair, bf16_pair, outs, parts in (
                        (dq_name, dq_kernel, 6.0, 8.0, q.numel(), ("dq",)),
                        (dkv_name, dkv_kernel, 8.0, 12.0,
                         k.numel() + v.numel(), ("dk", "dv"))):
                    work = per_pair * d * pairs * h * b
                    nbytes = ins + 4 * outs
                    byte_ms = nbytes / PEAK_BYTES * 1e3
                    # the least time for the function on these inputs:
                    # bf16 inputs at the card's bf16 rate, float32 ones
                    # as 3xTF32, on every route; beside it, the split
                    # work the route
                    # runs (bf16 P and dS split hi + lo on wgmma, 3xTF32
                    # for float32 inputs, the reduced split for bf16
                    # inputs at the TF32 rate) and float32 at the CUDA
                    # cores' rate
                    fp32_ms = work / PEAK_FLOPS["float32"] * 1e3
                    bf16_work = bf16_pair / per_pair * work
                    split_ms = {
                        "sm90": bf16_work / PEAK_FLOPS["bfloat16"] * 1e3,
                        "tf32x3": (3 * work if dtype == torch.float32
                                   else bf16_work)
                        / PEAK_FLOPS["tf32"] * 1e3}[route]
                    op_ms = (3 * work / PEAK_FLOPS["tf32"]
                             if dtype == torch.float32
                             else work / PEAK_FLOPS["bfloat16"]) * 1e3
                    ms = _time_ms(torch, fn)
                    part = {
                        "ms": ms, "bound_ms": max(op_ms, byte_ms),
                        "bound_by": "operations" if op_ms >= byte_ms
                        else "bytes", "flops": work, "bytes": nbytes,
                        "boundFloat32Ms": fp32_ms, "boundSplitMs": split_ms,
                        "boundExpMs": exp_ms}
                    figures = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=part["bound_ms"],
                        bound_by=part["bound_by"], library_ms=library_ms,
                        libraryBackend=sdpa["backwardBackend"],
                        max_abs_err=max(e for e, p in zip(
                            errs, ("dq", "dk", "dv")) if p in parts),
                        dtype=dt, boundFloat32Ms=fp32_ms,
                        boundSplitMs=split_ms, boundExpMs=exp_ms,
                        smClockMaxMhz=clock["smClockMaxMhz"],
                        shape=[b, sq, sk, h, kvh, d],
                        splitEmulationUsed={
                            p: line["splitEmulationUsed"][p]
                            for p in parts})
                    if route == "sm90":
                        figures["derivedBoundUsed"] = {
                            p: line["derivedBoundUsed"][p] for p in parts}
                    if nest:
                        entries.setdefault(kernel, {})[nest] = figures
                    else:
                        entries.setdefault(kernel, {}).update(figures)
                    line[kernel] = part
                line.update(plain_ms=plain_ms, library_ms=library_ms,
                            libraryBackend=sdpa["backwardBackend"],
                            sdpaBackends=sdpa["figures"],
                            visiblePairs=pairs, **clock)
                if name == "classifier":
                    # the whole backward as the fit runs it (_flash_bwd:
                    # the kernels, and on the narrow route nothing else
                    # but the casts to bf16 the autograd function makes)
                    def whole():
                        return [g.to(dtype) for g in attn._flash_bwd(
                            q, k, v, o, lse, do, dlse, causal, scale,
                            window, offset)]

                    whole_ms = _time_ms(torch, whole)
                    kernels_ms = sum(line[n]["ms"] for n in (dq_name,
                                                             dkv_name))
                    line["wholeBackward"] = {
                        "ms": whole_ms, "kernelsMs": kernels_ms,
                        "glueMs": whole_ms - kernels_ms,
                        "glueShare": (whole_ms - kernels_ms) / whole_ms,
                        "sdpaBackwardMs": library_ms}
                    for n in (dq_name, dkv_name):
                        entries[n][nest]["wholeBackward"] = \
                            line["wholeBackward"]
            log.append("kernel " + json.dumps(line))
            del q, k, v, do, o, lse, delta, got, want
    return entries


def _http(base, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + PREFIX + path, data=data,
                                 method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _predict_round(base, model: str, prompts, new: int = NEW_TOKENS):
    """``len(prompts)`` concurrent greedy predicts of ``new`` tokens on
    session ``model``: ``(results, client walls, round wall)``, each
    result ``(status, body)``."""
    out = [None] * len(prompts)
    walls = [0.0] * len(prompts)

    def client(i):
        c0 = time.monotonic()
        out[i] = _http(base, "POST", f"/serve/{model}/predict",
                       {"prompt": prompts[i], "maxNewTokens": new})
        walls[i] = time.monotonic() - c0

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out, walls, time.monotonic() - t0


def _round_tokens(name: str, out, new: int = NEW_TOKENS) -> list:
    """The tokens of a round's results; raises on a failed predict or a
    token outside the vocabulary."""
    tokens = []
    for i, result in enumerate(out):
        if result is None or result[0] != 200:
            raise AssertionError(f"{name} predict {i}: {result}")
        got = result[1]["tokens"]
        if len(got) != new or not all(
                0 < t < LM_CONFIG["vocab_size"] for t in got):
            raise AssertionError(f"{name} predict {i}: bad tokens {got}")
        tokens.append(got)
    return tokens


def _round_rates(out, walls, new: int = NEW_TOKENS) -> dict:
    """Decode tokens/s of a round (every stream's tokens after the first
    over the longest decode) and its TTFT as each client saw it: the
    request's wall less the decode after the first token."""
    decode_s = max(r[1]["decodeSeconds"] for r in out)
    ttft_ms = sorted((w - r[1]["decodeSeconds"]) * 1e3
                     for w, r in zip(walls, out))
    return {"clientTtftMs": {"p50": ttft_ms[(len(ttft_ms) - 1) // 2],
                             "max": ttft_ms[-1], "all": ttft_ms},
            "maxDecodeSeconds": decode_s,
            "decodeTokensPerSec": len(out) * (new - 1) / decode_s}


def _diverges(name: str, tokens, want) -> None:
    for i, (got, ref) in enumerate(zip(tokens, want)):
        ref = [int(t) for t in ref]
        if got != ref:
            first = next(j for j, (a, b) in enumerate(zip(got, ref))
                         if a != b)
            raise AssertionError(f"{name} predict {i} diverges from "
                                 f"solo generate at token {first}")


def slice_phase(torch, log, home, yard):
    """REST create -> 4 concurrent predicts -> stats -> delete. Returns
    the kernel launches of the serving path; leaves the prompts, the
    solo ``generate`` tokens and the slot session's tokens in ``yard``
    for the paged phase."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    state = weights.params_from_flax(weights.init_params(LM_CONFIG, seed=0))
    lm = LanguageModel(**LM_CONFIG, device="cuda")
    lm.set_params(state)
    ctx = ServiceContext(Config(home=home), device="cuda")
    ctx.artifacts.save(lm, "lm", "train/tensorflow")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, LM_CONFIG["vocab_size"],
                                             size=n)]
               for n in PROMPT_LENS]
    server = RestServer(port=0, context=ctx).start()
    rounds = []
    try:
        _reset_launches(attn)
        status, body = _http(server.base_url, "POST", "/serve/lm", {
            "type": "lm", "maxSlots": 4, "cacheLen": 2048,
            "temperature": 0.0})
        if status != 201:
            raise AssertionError(f"create: {status} {body}")
        # round 1 pays first use on the session's worker thread (library
        # handles, first launches); round 2 sends the same requests warm
        for name in ("cold", "warm"):
            out, walls, wall = _predict_round(server.base_url, "lm",
                                              prompts)
            status, stats = _http(server.base_url, "GET", "/serve/lm")
            if status != 200:
                raise AssertionError(f"stats: {status} {stats}")
            rounds.append((name, out, walls, wall, stats))
        launches = _launches(attn)
        status, deleted = _http(server.base_url, "DELETE", "/serve/lm")
        if status != 200 or deleted.get("deleted") is not True:
            raise AssertionError(f"delete: {status} {deleted}")
    finally:
        server.stop()

    need = LM_CONFIG["n_layers"] * len(prompts) * len(rounds)
    if launches["flash_fwd_tf32x3"] < need:
        raise AssertionError(f"flash_fwd_tf32x3 launched "
                             f"{launches['flash_fwd_tf32x3']} times on the "
                             f"serving path; {len(prompts) * len(rounds)} "
                             f"prefills of {LM_CONFIG['n_layers']} layers "
                             f"need {need}")
    if any(n for k, n in launches.items() if k != "flash_fwd_tf32x3"):
        raise AssertionError(f"serving (float32) ran a kernel other than "
                             f"flash_fwd_tf32x3: {launches}")
    solos = [lm.generate([p], max_new_tokens=NEW_TOKENS)[0][len(p):]
             for p in prompts]
    report = []
    for name, out, walls, wall, stats in rounds:
        tokens = _round_tokens(name, out)
        _diverges(name, tokens, solos)
        # this round's own TTFT (session stats pool every round's)
        report.append({
            "round": name, "wallSeconds": wall, **_round_rates(out, walls),
            "statsSoFar": {k: stats[k] for k in (
                "ttft", "roles", "perf", "tokensTotal")}})
    yard.update(prompts=prompts, solos=[[int(t) for t in x] for x in solos],
                slotTokens=tokens)
    report.append(_decode_profile(torch, lm, prompts))
    # the prefill logits through the kernel against the dense path
    dense = LanguageModel(**LM_CONFIG, attention="dot", device="cuda")
    dense.set_params(state)
    tokens = torch.tensor([prompts[-1]], device="cuda")
    with torch.inference_mode():
        got = lm.module(tokens)
        want = dense.module(tokens)
    if not bool(torch.isfinite(got).all()) or \
            got.shape != (1, PROMPT_LENS[-1], LM_CONFIG["vocab_size"]):
        raise AssertionError("prefill logits not finite or misshapen")
    logit_err = (got - want).abs().max().item()
    if not logit_err <= 1e-3:
        raise AssertionError(f"flash vs dot prefill logits: {logit_err}")
    log.append("slice " + json.dumps({
        "prompts": list(PROMPT_LENS), "newTokens": NEW_TOKENS,
        "launches": launches, "tokensEqualSolo": True,
        "prefillLogitsMaxAbsErrVsDot": logit_err, "rounds": report}))
    return launches


# the paged phase: a pool of 16-token pages at the slot session's bytes
# (4 slots x 2048 rows + the trash page = 513 pages), and 16 streams of
# 64-448 prompt tokens on it
PAGE_LEN, PAGED_STREAMS, PAGED_PROMPTS = 16, 16, (64, 448)
# the prompt that shares the 1367-token prompt's first 64 pages
SHARED_PREFIX = 1024


def _create(base, model: str, body: dict) -> dict:
    status, resp = _http(base, "POST", f"/serve/{model}", body)
    if status != 201:
        raise AssertionError(f"create {body}: {status} {resp}")
    return resp


def _agreement(tokens, want) -> dict:
    """Greedy agreement of a round with the exact session's: streams
    equal in full, tokens equal in place, and each stream's first
    differing position (None where it never differs)."""
    first = [next((j for j, (a, b) in enumerate(zip(got, ref)) if a != b),
                  None) for got, ref in zip(tokens, want)]
    same = sum(a == b for got, ref in zip(tokens, want)
               for a, b in zip(got, ref))
    return {"streamsEqual": sum(f is None for f in first),
            "tokensEqualFrac": same / sum(len(t) for t in want),
            "firstDiff": first}


def paged_phase(torch, log, home, serve_yard):
    """Paged and quantized LM serving over REST on the card, float32 (every
    prefill on flash_fwd_tf32x3). (a) ``kv: "paged"`` with the slot
    session's shape (4 slots, cacheLen 2048, 16-token pages, the pool
    sized to the slot cache's bytes): the serving phase's 4 prompts
    (after a first-use round of other prompts) must give the slot
    session's and solo ``generate``'s tokens, 8 forward launches a
    prefill. (b) The 1500-token prompt again is an exact prefix hit (no
    launch, the same tokens); a prompt sharing the 1367-token prompt's
    first 1024 tokens reuses its 64 pages and runs its prefill. (c) 16
    slots on the same 513 pages: 16 prompts of 64-448 tokens all decode
    at once (the slot session at these bytes holds 4), each equal to
    solo. (d) int8 KV with int8 weights, and fp8 weights: drift stamped
    at create (int8 within 0.05), bytes per token, greedy agreement with
    (a), and with LO_SERVE_DRIFT_MAX at 1e-9 a session that degrades to
    exact and answers (a)'s tokens. Returns the launches of (a) and of
    the exact hit as paths "paged" and "pagedPrefixHit"."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    t0 = time.monotonic()
    state = weights.params_from_flax(weights.init_params(LM_CONFIG, seed=0))
    lm = LanguageModel(**LM_CONFIG, device="cuda")
    lm.set_params(state)
    ctx = ServiceContext(Config(home=home), device="cuda")
    ctx.artifacts.save(lm, "lm", "train/tensorflow")
    prompts, solos = serve_yard["prompts"], serve_yard["solos"]
    vocab = LM_CONFIG["vocab_size"]
    rng = np.random.default_rng(1)
    first_use = [[int(t) for t in rng.integers(1, vocab, size=n)]
                 for n in PROMPT_LENS]
    shared = prompts[2][:SHARED_PREFIX] + [
        int(t) for t in rng.integers(1, vocab, size=476)]
    many = [[int(t) for t in rng.integers(1, vocab, size=n)]
            for n in rng.integers(PAGED_PROMPTS[0], PAGED_PROMPTS[1] + 1,
                                  size=PAGED_STREAMS)]

    def solo(p):
        return [int(t) for t in
                lm.generate([p], max_new_tokens=NEW_TOKENS)[0][len(p):]]

    shared_solo, many_solo = solo(shared), [solo(p) for p in many]
    paged = {"type": "lm", "kv": "paged", "maxSlots": 4, "cacheLen": 2048,
             "pageLen": PAGE_LEN, "temperature": 0.0}
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    report: dict = {"prompts": list(PROMPT_LENS), "newTokens": NEW_TOKENS}
    try:
        # (a) paged against slot and solo
        resp = _create(base, "lm", paged)
        if resp["kv"]["pagesTotal"] != 4 * 2048 // PAGE_LEN or \
                resp["kv"]["dtype"] != "bf16":
            raise AssertionError(f"paged pool: {resp['kv']}")
        exact_bpt = resp["kv"]["bytesPerToken"]
        _round_tokens("paged first use", _predict_round(base, "lm",
                                                        first_use)[0])
        _reset_launches(attn)
        out, walls, wall = _predict_round(base, "lm", prompts)
        launches = _launches(attn)
        exact = _round_tokens("paged", out)
        _diverges("paged", exact, solos)
        if exact != serve_yard["slotTokens"]:
            raise AssertionError("paged tokens differ from the slot "
                                 "session's")
        need = LM_CONFIG["n_layers"] * len(prompts)
        if launches["flash_fwd_tf32x3"] != need or any(
                n for k, n in launches.items() if k != "flash_fwd_tf32x3"):
            raise AssertionError(f"paged prefills launched {launches}; "
                                 f"{need} flash_fwd_tf32x3 expected")
        report["a"] = {"launches": launches, "tokensEqualSolo": True,
                       "tokensEqualSlot": True, "wallSeconds": wall,
                       "bytesPerToken": exact_bpt,
                       **_round_rates(out, walls)}

        # (b) an exact prefix hit, then a shared prefix
        _reset_launches(attn)
        out, walls, _ = _predict_round(base, "lm", prompts[3:])
        hit_launches = _launches(attn)
        _diverges("prefix hit", _round_tokens("prefix hit", out),
                  solos[3:])
        hit_ttft = _round_rates(out, walls)["clientTtftMs"]["p50"]
        if any(hit_launches.values()):
            raise AssertionError(f"an exact prefix hit launched "
                                 f"{hit_launches}")
        before = _http(base, "GET", "/serve/lm")[1]["kv"]["prefix"]
        _reset_launches(attn)
        out, _, _ = _predict_round(base, "lm", [shared])
        shared_launches = _launches(attn)
        _diverges("shared prefix", _round_tokens("shared prefix", out),
                  [shared_solo])
        prefix = _http(base, "GET", "/serve/lm")[1]["kv"]["prefix"]
        reused = prefix["pagesReused"] - before["pagesReused"]
        if prefix["hitsPartial"] != before["hitsPartial"] + 1 or \
                reused != SHARED_PREFIX // PAGE_LEN or \
                shared_launches["flash_fwd_tf32x3"] != LM_CONFIG["n_layers"]:
            raise AssertionError(f"shared prefix: {reused} pages reused, "
                                 f"{prefix}, {shared_launches}")
        report["b"] = {"exactHitLaunches": hit_launches,
                       "exactHitTtftMs": hit_ttft,
                       "sharedPagesReused": reused,
                       "sharedLaunches": shared_launches, "prefix": prefix}
        _http(base, "DELETE", "/serve/lm")

        # (c) 16 streams on the same bytes
        resp = _create(base, "lm", dict(paged, maxSlots=PAGED_STREAMS,
                                        pages=4 * 2048 // PAGE_LEN + 1))
        _round_tokens("16 streams first use", _predict_round(
            base, "lm", first_use[:1])[0])
        out, walls, wall = _predict_round(base, "lm", many)
        _diverges("16 streams", _round_tokens("16 streams", out), many_solo)
        stats = _http(base, "GET", "/serve/lm")[1]
        if stats["peakActiveSlots"] != PAGED_STREAMS:
            raise AssertionError(f"16 streams: at most "
                                 f"{stats['peakActiveSlots']} decoded at "
                                 f"once")
        report["c"] = {"streams": PAGED_STREAMS,
                       "promptLens": [len(p) for p in many],
                       "peakActiveSlots": stats["peakActiveSlots"],
                       "pagesTotal": stats["kv"]["pagesTotal"],
                       "tokensEqualSolo": True, "wallSeconds": wall,
                       **_round_rates(out, walls)}
        _http(base, "DELETE", "/serve/lm")

        # (d) quantized sessions; the gate off (max 0) measures fp8 as it
        # serves, 1e-9 forces a breach
        report["d"] = {}
        for name, extra, drift_max in (
                ("int8", {"kvDtype": "int8", "weights": "int8"}, None),
                ("fp8", {"weights": "fp8"}, None),
                ("fp8Ungated", {"weights": "fp8"}, 0.0),
                ("forcedBreach", {"kvDtype": "int8", "weights": "int8"},
                 1e-9)):
            default_max = ctx.config.serve_drift_max
            if drift_max is not None:
                ctx.config.serve_drift_max = drift_max
            try:
                resp = _create(base, "lm", dict(paged, **extra))
            finally:
                ctx.config.serve_drift_max = default_max
            _round_tokens(f"{name} first use",
                          _predict_round(base, "lm", first_use)[0])
            out, walls, _ = _predict_round(base, "lm", prompts)
            tokens = _round_tokens(name, out)
            row = {"drift": resp.get("drift"), "quant": resp["quant"],
                   "kv": {k: resp["kv"][k] for k in ("dtype",
                                                     "bytesPerToken")},
                   "exactBytesPerToken": exact_bpt,
                   "weights": resp["weights"],
                   "agreement": _agreement(tokens, exact),
                   **_round_rates(out, walls)}
            degraded = resp["quant"]["degrades"] > 0
            if name == "int8" and (degraded or not resp["drift"]["value"]
                                   <= 0.05):
                raise AssertionError(f"int8 session drift: {row}")
            if name == "forcedBreach" and not degraded:
                raise AssertionError(f"a drift max of 1e-9 did not "
                                     f"degrade: {row}")
            if degraded:
                if resp["kv"]["dtype"] != "bf16" or \
                        resp["weights"]["dtype"] != "bf16":
                    raise AssertionError(f"{name} degraded to {row}")
                _diverges(f"{name} (degraded)", tokens, solos)
            report["d"][name] = row
            _http(base, "DELETE", "/serve/lm")
    finally:
        server.stop()
    report["decodeProfile"] = _decode_profile(torch, lm, prompts, paged=True)
    report["seconds"] = time.monotonic() - t0
    log.append("paged " + json.dumps(report))
    return {"paged": launches, "pagedPrefixHit": hit_launches}


def _decode_profile(torch, lm, prompts, paged: bool = False,
                    steps: int = 8):
    """Where a warm decode step's time goes: ``steps`` steps of 4 filled
    slots (``paged``: 4 streams over a pool of 16-token pages, each
    stream's 128 pages gathered) under ``torch.profiler``, with the host
    wall per step and the top operators by device and by host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    if paged:
        pages = 2048 // PAGE_LEN
        step, prefill_for, join_paged, _, _ = lm.serve_fns_paged(
            4, 2048, PAGE_LEN, 4 * pages + 1, 0.0)
        cache = lm.serve_cache_paged(4 * pages + 1, PAGE_LEN)
        tables = 1 + torch.arange(4 * pages, device="cuda").reshape(4, pages)
    else:
        step, prefill_for, join = lm.serve_fns(4, 2048, 0.0)
        cache = lm.serve_cache(4, 2048)
    col = np.zeros(4, np.int64)
    tok = np.zeros((4, 1), np.int64)
    for slot, prompt in enumerate(prompts):
        tokens = torch.tensor([prompt], device="cuda")
        if paged:
            nxt, _, pcache = prefill_for(len(prompt))(tokens, 0)
            join_paged(cache, pcache,
                       tables[slot, :-(-len(prompt) // PAGE_LEN)], 0)
        else:
            nxt, pcache = prefill_for(len(prompt))(tokens, 0)
            join(cache, pcache, slot)
        tok[slot, 0], col[slot] = int(nxt[0]), len(prompt)
    seeds = np.zeros(4, np.int64)

    def run(n):
        for _ in range(n):
            if paged:
                nxt = step(cache, tok, col, tables, seeds).cpu().numpy()
            else:
                nxt = step(cache, tok, col, seeds).cpu().numpy()
            tok[:, 0] = nxt
            col[:] += 1

    run(4)
    t0 = time.monotonic()
    run(steps)
    wall_ms = (time.monotonic() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]

    def top(rows, attr):
        rows = sorted(rows, key=lambda e: getattr(e, attr), reverse=True)
        return [[e.key[:80], round(getattr(e, attr) / steps / 1e3, 4),
                 e.count / steps] for e in rows[:10]]

    report = {"round": "pagedDecodeProfile" if paged else "decodeProfile",
              "steps": steps,
              "hostWallMsPerStep": wall_ms,
              "deviceBusyMsPerStep": sum(
                  e.self_device_time_total for e in kernels) / steps / 1e3,
              "kernelLaunchesPerStep": sum(e.count for e in kernels) / steps,
              "topKernelsMs": top(kernels, "self_device_time_total"),
              "topHostMs": top(events, "self_cpu_time_total")}
    # a dropped profile leaves some 220,000 objects in reference cycles:
    # collect them here, or a generation-2 collection lands in a later
    # timed round (0.34 s of the paged phase's 16-stream TTFT on the card)
    del prof, events, kernels
    gc.collect()
    return report


def _successor_windows(np, n: int, seq: int, seed: int):
    """``n`` windows of ``seq`` tokens of the stream where id t is
    followed by t % 63 + 1; each window starts at an id drawn from
    ``seed``."""
    start = np.random.default_rng(seed).integers(1, 64, size=n)
    return ((start[:, None] - 1 + np.arange(seq)[None, :]) % 63 + 1) \
        .astype(np.int32)


def _domain_windows(np, n: int, seq: int, seed: int):
    """``n`` windows of ``seq`` tokens of a second stream, where id t is
    followed by (t + 6) % 97 + 1; each window starts at an id drawn from
    ``seed``."""
    start = np.random.default_rng(seed).integers(1, 98, size=n)
    return ((start[:, None] - 1 + 7 * np.arange(seq)[None, :]) % 97 + 1) \
        .astype(np.int32)


def _marker_rows(np, n: int, seq: int, vocab: int, seed: int):
    """``n`` rows of ``seq`` tokens drawn from [2, vocab) with lengths
    64..seq padded with 0, and labels: whether the marker id 1 appears
    anywhere in the row (a task only bidirectional attention into the
    pool can see; tests/test_transformer.py's classifier task)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(2, vocab, size=(n, seq)).astype(np.int32)
    lengths = rng.integers(64, seq + 1, size=n)
    y = rng.integers(0, 2, size=n).astype(np.int32)
    pos = (rng.random(n) * lengths).astype(np.int64)
    rows = np.arange(n)[y == 1]
    x[rows, pos[y == 1]] = 1
    x[np.arange(seq)[None, :] >= lengths[:, None]] = 0
    return x, y


def _float32_fit_window(torch, lm, x, log) -> dict:
    """The fit of the train phase in float32 (``LO_COMPUTE_DTYPE``): one
    optimizer step of first use, 2 timed steps (host clock to a
    synchronize), then the same 2 batches again under the profiler, each
    step of TRAIN_BATCH windows at grad_accum TRAIN_ACCUM. The params are restored after it,
    so the artifact holds exactly the bf16 fit's steps. Logs the
    ``trainFloat32`` line and returns the kernel launches of the 2 timed
    steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from learningorchestra_tpu_torch.ops import attention as attn

    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    lm._engine = None
    try:
        eng = lm._get_engine()
        if eng._compute_dtype != torch.float32 or \
                eng._grad_accum != TRAIN_ACCUM:
            raise AssertionError("the float32 window must run the fit's "
                                 "float32 engine at its grad_accum")
        params = lm._master_params()
        saved = {k: p.detach().clone() for k, p in params.items()}
        tstate = eng.init_state(params)
        batches = [eng._to_device(b, lm.device) for b in
                   lm._batcher(x[:3 * TRAIN_BATCH], TRAIN_BATCH).epoch(0)]
        eng._train_step_body(tstate, batches[0], 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(attn)
        t0 = time.monotonic()
        losses = [eng._train_step_body(tstate, batch, 0)["loss"]
                  for batch in batches[1:3]]
        torch.cuda.synchronize()
        step_ms = (time.monotonic() - t0) / 2 * 1e3
        launches = _launches(attn)
        peak_bytes = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.monotonic()
            for batch in batches[1:3]:
                eng._train_step_body(tstate, batch, 0)
            torch.cuda.synchronize()
            window_ms = (time.monotonic() - w0) * 1e3
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])
        losses = [float(s) / float(c) for s, c in losses]
        del saved, tstate, batches
    finally:
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
        lm._engine = None
    if not all(np.isfinite(losses)):
        raise AssertionError(f"float32 window losses {losses}")
    need = LM_CONFIG["n_layers"] * TRAIN_ACCUM * 2
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_fwd_tf32x3=need, flash_bwd_dq_tf32x3=need,
                flash_bwd_dkv_tf32x3=need)
    if launches != want:
        raise AssertionError(f"kernel launches in the float32 window "
                             f"{launches}; 2 steps of {TRAIN_ACCUM} "
                             f"micro-batches of {LM_CONFIG['n_layers']} "
                             f"layers need {want}")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    per_step = {name: sum(e.self_device_time_total for e in kernels
                          if f"{name}_kernel" in e.key) / 2e3
                for name in COUNTERS}
    top = [[e.key[:80], e.self_device_time_total / 2e3, e.count / 2]
           for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                           reverse=True)[:10]]
    del prof, kernels
    gc.collect()  # the profile's cycles (see _decode_profile)
    log.append("trainFloat32 " + json.dumps({
        "computeDtype": "float32", "optimizerSteps": 2,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "gradAccum": TRAIN_ACCUM,
        "stepMs": step_ms,
        "trainTokensPerSec": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
        "losses": losses, "launches": launches,
        "launchesPerStep": {k: n / 2 for k, n in launches.items() if n},
        "maxMemoryAllocatedBytes": peak_bytes,
        "profile": {"steps": 2, "windowMs": window_ms,
                    "deviceBusyMs": busy_ms,
                    "idleShare": 1.0 - busy_ms / window_ms,
                    "kernelMsPerStep": {k: v for k, v in per_step.items()
                                        if v},
                    "topKernelsMsPerStep": top}}))
    return launches


def _profiled_window(torch, lm, x) -> dict:
    """A profiler window of 2 optimizer steps of ``lm``'s fit engine on
    the first windows of ``x`` (after one step of first use): wall,
    device busy time, idle share and kernel time per step. The params
    are restored after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = lm._get_engine()
    params = lm._master_params()
    saved = {k: p.detach().clone() for k, p in params.items()}
    tstate = eng.init_state(params)
    batches = [eng._to_device(b, lm.device) for b in
               lm._batcher(x[:3 * TRAIN_BATCH], TRAIN_BATCH).epoch(0)]
    eng._train_step_body(tstate, batches[0], 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.monotonic()
        for batch in batches[1:]:
            eng._train_step_body(tstate, batch, 0)
        torch.cuda.synchronize()
        window_ms = (time.monotonic() - w0) * 1e3
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(saved[k])
    del saved, tstate, batches
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    per_step = {name: sum(e.self_device_time_total for e in kernels
                          if f"{name}_kernel" in e.key) / 2e3
                for name in COUNTERS}
    top = [[e.key[:80], e.self_device_time_total / 2e3, e.count / 2]
           for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                           reverse=True)[:10]]
    del prof, kernels
    gc.collect()  # the profile's cycles (see _decode_profile)
    return {"steps": 2, "windowMs": window_ms, "deviceBusyMs": busy_ms,
            "idleShare": 1.0 - busy_ms / window_ms,
            "kernelMsPerStep": per_step, "topKernelsMsPerStep": top}


def _grads_vs_dot(torch, path, config, init, dtype, limit, x) -> dict:
    """One micro-step of ``x`` in ``dtype`` through the split-TF32
    kernels (one launch of each per layer) against the same step on the
    dense path (plain autograd), both from ``init``: the launches and the
    worst per-tensor relative L2 error, which must be within ``limit``
    (None records it only)."""
    import numpy as np

    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime.data import MASK_KEY

    kernels = ("flash_fwd_tf32x3", "flash_bwd_dq_tf32x3",
               "flash_bwd_dkv_tf32x3")
    os.environ["LO_COMPUTE_DTYPE"] = dtype
    out, grads = {}, {}
    try:
        for impl in ("flash", "dot"):
            model = LanguageModel(**config, attention=impl, device="cuda")
            model.set_params(init)
            feng = model._get_engine()
            if feng._compute_dtype != getattr(torch, dtype):
                raise AssertionError(f"the gradient check must run in "
                                     f"{dtype}")
            batch = feng._to_device(
                {"x": x, MASK_KEY: np.ones(len(x), np.float32)},
                model.device)
            _reset_launches(attn)
            g, _ = feng._micro_grads(model._master_params(), batch, 0)
            ran = _launches(attn)
            want_ran = dict.fromkeys(COUNTERS, 0)
            if impl == "flash":
                want_ran.update(dict.fromkeys(kernels, config["n_layers"]))
            if ran != want_ran:
                raise AssertionError(f"{path} {impl} gradient step launched "
                                     f"{ran}, want {want_ran}")
            if not all(bool(torch.isfinite(t).all()) for t in g.values()):
                raise AssertionError(f"{path} {impl}: gradients not finite")
            if impl == "flash":
                out["launches"] = ran
            grads[impl] = g
            del model, feng, batch
    finally:
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    rel = {k: ((grads["flash"][k].float() - grads["dot"][k].float())
               .norm() / grads["dot"][k].float().norm().clamp_min(1e-30))
           .item() for k in grads["dot"]}
    worst = max(rel, key=rel.get)
    if limit is not None and not rel[worst] <= limit:
        raise AssertionError(f"{path}: kernel vs dense gradient of "
                             f"{worst}: relative L2 error {rel[worst]}")
    out["relL2VsDot"] = {"max": rel[worst], "worst": worst}
    return out


def train_phase(torch, log, home, yard):
    """fit on the card -> checks -> a profiled 2-step window -> a float32
    window of the same fit -> kernel-vs-dense gradients -> save, serve
    over REST, predict. Returns the kernel launches of each path it
    drove: the bf16 fit, the float32 fit window, the two float32
    gradient steps and the d-12 LM's bf16 gradient step. Leaves the
    fit's windows, epoch losses and trained model in ``yard``, the
    pipeline phase's yardstick."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    state = weights.params_from_flax(weights.init_params(LM_CONFIG, seed=0))
    x = _successor_windows(np, TRAIN_WINDOWS, TRAIN_SEQ, seed=0)
    lm = LanguageModel(**LM_CONFIG, device="cuda")
    lm.set_params(state)
    if lm._get_engine()._compute_dtype != torch.bfloat16:
        raise AssertionError("the training path must compute in bf16")
    steps = TRAIN_EPOCHS * TRAIN_WINDOWS // TRAIN_BATCH
    micro = steps * TRAIN_ACCUM
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(attn)
    t0 = time.monotonic()
    hist = lm.fit(x, batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                  grad_accum=TRAIN_ACCUM).history
    fit_s = time.monotonic() - t0
    launches = _launches(attn)
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = hist["loss"]
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_EPOCHS:
        raise AssertionError(f"training losses {losses}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not all(abs(a - b) <= 0.01 * b
               for a, b in zip(losses, CUDA_CORE_LOSSES)):
        raise AssertionError(f"epoch losses {losses} are not within 1% of "
                             f"the CUDA-core kernels' {CUDA_CORE_LOSSES}")
    # bf16: the forward, dq and dK/dV take the tensor-core route, every
    # time
    need = LM_CONFIG["n_layers"] * micro
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_fwd_sm90=need, flash_bwd_dq_sm90=need,
                flash_bwd_dkv_sm90=need)
    if launches != want:
        raise AssertionError(f"kernel launches during fit {launches}; "
                             f"{micro} micro-batches of "
                             f"{LM_CONFIG['n_layers']} layers need {want}")
    # steady-state step time: the second epoch, after first use
    step_ms = hist["epochSeconds"][1] / (steps // TRAIN_EPOCHS) * 1e3
    tokens_per_s = TRAIN_WINDOWS * TRAIN_SEQ / hist["epochSeconds"][1]

    # a profiled window of 2 optimizer steps; the params are restored
    # after it, so the artifact holds exactly the fit's 8 steps
    window = _profiled_window(torch, lm, x)

    f32_fit = _float32_fit_window(torch, lm, x, log)

    # one micro-step of 2 windows through the split-TF32 kernels, one
    # launch of each per layer, against the same step on the dense path
    # (plain autograd): in float32 for the tutorial LM (head_dim 64) and
    # the d-12 LM (the width-16 variants), each within 1e-4; in bf16 for
    # the d-12 LM, finite, its error against the bf16 dense path recorded
    # only (the kernel phase holds the kernels' numbers)
    f32_grad = {}
    for path, config, dtype, limit in (
            ("trainFloat32Grad", LM_CONFIG, "float32", 1e-4),
            ("trainFloat32GradD12", D12_CONFIG, "float32", 1e-4),
            ("trainBf16GradD12", D12_CONFIG, "bfloat16", None)):
        init = state if config is LM_CONFIG else weights.params_from_flax(
            weights.init_params(config, seed=0))
        f32_grad[path] = _grads_vs_dot(torch, path, config, init, dtype,
                                       limit, x[:2])

    # the trained artifact, reloaded and served over REST
    ctx = ServiceContext(Config(home=home), device="cuda")
    ctx.artifacts.save(lm, "trained", "train/tensorflow")
    loaded = ctx.artifacts.load("trained")
    if loaded.history != lm.history:
        raise AssertionError("the artifact lost the training history")
    prompt = [int(t) for t in x[0, :256]]
    server = RestServer(port=0, context=ctx).start()
    try:
        status, body = _http(server.base_url, "POST", "/serve/trained", {
            "type": "lm", "maxSlots": 2, "cacheLen": 512,
            "temperature": 0.0})
        if status != 201:
            raise AssertionError(f"create: {status} {body}")
        status, out = _http(server.base_url, "POST",
                            "/serve/trained/predict",
                            {"prompt": prompt, "maxNewTokens": NEW_TOKENS})
        if status != 200:
            raise AssertionError(f"predict: {status} {out}")
        _http(server.base_url, "DELETE", "/serve/trained")
    finally:
        server.stop()
    want = [int(t) for t in loaded.generate(
        [prompt], max_new_tokens=NEW_TOKENS)[0][len(prompt):]]
    if out["tokens"] != want:
        raise AssertionError(f"served tokens {out['tokens']} differ from "
                             f"the reloaded model's generate {want}")
    follows = sum(t == p % 63 + 1 for p, t in
                  zip([prompt[-1]] + want[:-1], want)) / len(want)
    yard.update(x=x, losses=list(losses), lm=lm)
    log.append("train " + json.dumps({
        "config": LM_CONFIG, "windows": TRAIN_WINDOWS, "seq": TRAIN_SEQ,
        "batch": TRAIN_BATCH, "epochs": TRAIN_EPOCHS,
        "gradAccum": TRAIN_ACCUM, "optimizerSteps": steps,
        "microBatches": micro, "computeDtype": "bfloat16",
        "history": hist, "fitSeconds": fit_s, "launches": launches,
        "stepMs": step_ms, "trainTokensPerSec": tokens_per_s,
        "maxMemoryAllocatedBytes": peak_bytes,
        "profile": window,
        "f32GradRelL2VsDot": f32_grad["trainFloat32Grad"]["relL2VsDot"],
        "f32GradLaunches": f32_grad["trainFloat32Grad"]["launches"],
        "f32GradD12": f32_grad["trainFloat32GradD12"],
        "bf16GradD12": f32_grad["trainBf16GradD12"],
        "servedTokensEqualGenerate": True,
        "servedSuccessorShare": follows}))
    return {"train": launches, "trainFloat32": f32_fit,
            **{path: c["launches"] for path, c in f32_grad.items()}}


def _poll(base, path, timeout: float = 600.0,
          interval: float = 0.25) -> dict:
    """Polls ``path`` every ``interval`` seconds (the JAX client's
    default) until ``finished``; the metadata document then. A job that
    records an exception fails the phase with its document."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, body = _http(base, "GET", path + "?limit=1")
        if status != 200:
            raise AssertionError(f"GET {path}: {status} {body}")
        if body["metadata"]["finished"]:
            return body["metadata"]
        if body["metadata"].get("status") == "deadLettered":
            failed = _http(base, "GET", path)[1]["result"][-1]
            raise AssertionError(f"job {path} failed: {failed}")
        time.sleep(interval)
    raise AssertionError(f"{path} did not finish in {timeout} s")


def pipeline_phase(torch, log, home, yard):
    """The tutorial's LM workflow over HTTP against a RestServer on the
    card, held against the train phase: ingest the train phase's 64
    windows as a CSV, create the LM through the JAX package's module
    path, fit it (8 optimizer steps, bf16), evaluate, generate, serve
    the trained artifact, and check that refused and failed requests
    are recorded. Returns the kernel launches of the REST fit, evaluate
    and generate."""
    import numpy as np

    from learningorchestra_tpu_torch.catalog.store import Table
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime.data import dataframe_to_arrays
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    # the train phase's float32 windows changed it; a REST model builds
    # its engine from it
    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    x = yard["x"]
    csv_path = os.path.join(home, "corpus.csv")
    with open(csv_path, "w") as f:
        f.write(",".join(f"t{i}" for i in range(x.shape[1])) + "\n")
        for row in x:
            f.write(",".join(map(str, row.tolist())) + "\n")
    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    steps = TRAIN_EPOCHS * TRAIN_WINDOWS // TRAIN_BATCH
    launches = {}

    def post(path, body, want=201):
        status, out = _http(base, "POST", path, body)
        if status != want:
            raise AssertionError(f"POST {path}: {status} {out}")
        return out

    job_seconds = {}

    def job(verb, name, parent, method, params):
        """POST a job (or, with ``parent`` None, PATCH the execution
        ``name`` with new parameters) and poll it to ``finished``;
        (seconds, GET body, launches). The job's own seconds (queue wait
        + run, from its execution document) go to ``job_seconds``."""
        _reset_launches(attn)
        t0 = time.monotonic()
        if parent is None:
            status, out = _http(base, "PATCH", f"/{verb}/tensorflow/{name}",
                                {"methodParameters": params})
            if status != 200:
                raise AssertionError(f"PATCH {name}: {status} {out}")
        else:
            post(f"/{verb}/tensorflow", {"name": name, "modelName": parent,
                                         "method": method,
                                         "methodParameters": params})
        _poll(base, f"/{verb}/tensorflow/{name}")
        wall = time.monotonic() - t0
        ran = _launches(attn)
        record_job(name)
        status, body = _http(base, "GET", f"/{verb}/tensorflow/{name}")
        return wall, body, ran

    def record_job(name):
        # the job marks the collection finished, then appends its
        # execution document
        for _ in range(400):
            done = ctx.catalog.get_documents(name)[-1]
            if "queueWaitSeconds" in done:
                break
            time.sleep(0.025)
        job_seconds[name] = done["queueWaitSeconds"] + done["elapsedSeconds"]

    def result(body):
        return next(d["result"] for d in body["result"] if "result" in d)

    phase_t0 = time.monotonic()
    try:
        t0 = time.monotonic()
        post("/dataset/csv", {"datasetName": "corpus",
                              "datasetURI": csv_path})
        meta = _poll(base, "/dataset/csv/corpus")
        ingest_s = time.monotonic() - t0
        record_job("corpus")
        if meta["rows"] != TRAIN_WINDOWS or len(meta["fields"]) != TRAIN_SEQ:
            raise AssertionError(f"ingested metadata {meta}")
        status, page = _http(base, "GET",
                             "/dataset/csv/corpus?skip=0&limit=2")
        head, first = page["result"]
        if status != 200 or head["_id"] != 0 or first["_id"] != 1 or \
                [first[f"t{i}"] for i in range(TRAIN_SEQ)] != x[0].tolist():
            raise AssertionError("the first page is not the metadata "
                                 "document and the first window")
        t0 = time.monotonic()
        table = ctx.params.resolve_value("$corpus")
        feed = dataframe_to_arrays(table)["x"]
        host = {"tableReadAndFeedSeconds": time.monotonic() - t0}
        if not isinstance(table, Table) or not np.array_equal(feed, x):
            raise AssertionError("$corpus does not give the windows")

        t0 = time.monotonic()
        post("/model/tensorflow", {
            "modelName": "lm", "modulePath": "learningorchestra_tpu.models",
            "class": "LanguageModel", "classParameters": LM_CONFIG})
        _poll(base, "/model/tensorflow/lm")
        create_s = time.monotonic() - t0
        record_job("lm")

        # the tutorial's body: checkpointed after each epoch
        fit_params = {"x": "$corpus", "batch_size": TRAIN_BATCH,
                      "epochs": TRAIN_EPOCHS, "grad_accum": TRAIN_ACCUM,
                      "checkpoint": True}
        fit_s, body, launches["pipelineFit"] = job(
            "train", "lm_t", "lm", "fit", fit_params)
        records = [d["epochRecord"] for d in body["result"]
                   if "epochRecord" in d]
        losses = [r["loss"] for r in records]
        if not body["metadata"]["finished"] or len(records) != TRAIN_EPOCHS:
            raise AssertionError(f"fit documents {body['result']}")
        if losses != yard["losses"]:
            raise AssertionError(f"REST fit losses {losses} differ from the "
                                 f"train phase's {yard['losses']}")
        need = LM_CONFIG["n_layers"] * steps * TRAIN_ACCUM
        want = dict.fromkeys(COUNTERS, 0)
        want.update(flash_fwd_sm90=need, flash_bwd_dq_sm90=need,
                    flash_bwd_dkv_sm90=need)
        if launches["pipelineFit"] != want:
            raise AssertionError(f"REST fit launched "
                                 f"{launches['pipelineFit']}, want {want}")
        epoch_s = [r["epochSeconds"] for r in records]

        eval_s, body, launches["pipelineEvaluate"] = job(
            "evaluate", "lm_ev", "lm_t", "evaluate",
            {"x": "$corpus", "batch_size": TRAIN_BATCH})
        evaluated = result(body)
        direct = yard["lm"].evaluate(x, batch_size=TRAIN_BATCH)
        if set(evaluated) != set(direct) or not all(
                abs(evaluated[k] - direct[k]) <= 1e-6 * abs(direct[k])
                for k in direct):
            raise AssertionError(f"REST evaluate {evaluated} differs from "
                                 f"the trained model's {direct}")

        prompt = [int(t) for t in x[1, :PROMPT_LENS[0]]]
        gen_s, body, launches["pipelineGenerate"] = job(
            "predict", "lm_gen", "lm_t", "generate",
            {"prompt": [prompt], "max_new_tokens": NEW_TOKENS})
        tokens = result(body)[0][len(prompt):]
        t0 = time.monotonic()
        trained = ctx.artifacts.load("lm_t")
        host["trainedArtifactLoadSeconds"] = time.monotonic() - t0
        solo = trained.generate(
            [prompt], max_new_tokens=NEW_TOKENS)[0][len(prompt):].tolist()
        if tokens != solo or len(tokens) != NEW_TOKENS:
            raise AssertionError(f"REST generate {tokens} differs from the "
                                 f"reloaded artifact's {solo}")
        ran = launches["pipelineGenerate"]
        if ran["flash_fwd_tf32x3"] < LM_CONFIG["n_layers"] or any(
                n for k, n in ran.items() if k != "flash_fwd_tf32x3"):
            raise AssertionError(f"the generate prefill launched {ran}")

        post("/serve/lm_t", {"type": "lm", "maxSlots": 2,
                             "cacheLen": TRAIN_SEQ, "temperature": 0.0})
        served = post("/serve/lm_t/predict",
                      {"prompt": prompt, "maxNewTokens": NEW_TOKENS}, 200)
        _http(base, "DELETE", "/serve/lm_t")
        if served["tokens"] != tokens:
            raise AssertionError(f"served tokens {served['tokens']} differ "
                                 f"from the REST generate's {tokens}")

        checkpoints = _checkpoint_checks(ctx, "lm_t", steps)
        # the ckptAsync phase's yardstick
        yard["syncCheckpoint"] = {
            "losses": losses, "fitWallSeconds": fit_s,
            "commitSeconds": checkpoints["checkpointSaveSeconds"],
            "manifests": _manifests(os.path.join(
                ctx.config.checkpoints_dir, "lm_t")),
            "source": "the pipeline phase"}
        resume = _resume_checks(ctx, job, base, fit_params, losses, trained,
                                x, steps, launches)
        lora = _lora_checks(torch, ctx, job, post, base, home, trained,
                            launches)

        refused = post("/predict/tensorflow", {
            "name": "lm_slice", "modelName": "lm_t", "method": "generate",
            "methodParameters": {"prompt": [[1, 2]]}, "sliceDevices": 1},
            406)
        if _http(base, "GET", "/predict/tensorflow/lm_slice")[0] != 404:
            raise AssertionError("a refused request left a collection")
        post("/train/tensorflow", {"name": "lm_bad", "modelName": "lm",
                                   "method": "fit",
                                   "methodParameters": {"x": "$ghost"}})
        ctx.jobs.wait("lm_bad", timeout=600)
        status, bad = _http(base, "GET", "/train/tensorflow/lm_bad")
        if bad["metadata"]["finished"] or not bad["result"][-1].get(
                "exception"):
            raise AssertionError(f"the failed fit was not recorded: {bad}")
    finally:
        server.stop()
    per_step = {k: n / steps for k, n in launches["pipelineFit"].items() if n}
    log.append("pipeline " + json.dumps({
        "phaseSeconds": time.monotonic() - phase_t0, "pollSeconds": 0.25,
        "ingestSeconds": ingest_s, "ingestRows": TRAIN_WINDOWS,
        "ingestColumns": TRAIN_SEQ, "modelCreateSeconds": create_s,
        "fitWallSeconds": fit_s, "fitEpochSeconds": epoch_s,
        "jobSeconds": job_seconds,
        "jobPlaneOverheadSeconds": job_seconds["lm_t"] - sum(epoch_s),
        "hostSeconds": host,
        "losses": losses, "lossesEqualTrainPhase": True,
        "stepMsEpoch2": epoch_s[1] / (steps // TRAIN_EPOCHS) * 1e3,
        "trainTokensPerSecEpoch2": TRAIN_WINDOWS * TRAIN_SEQ / epoch_s[1],
        "launchesPerStep": per_step,
        "evaluateSeconds": eval_s, "evaluate": evaluated,
        "evaluateDirect": direct,
        "generateSeconds": gen_s, "generatePrompt": len(prompt),
        "generateTokensEqualSolo": True, "servedTokensEqual": True,
        "launches": launches, "checkpoints": checkpoints,
        "resume": resume, "lora": lora,
        "refusedSliceDevices": refused["result"],
        "failedJobException": bad["result"][-1]["exception"]}))
    shutil.rmtree(ctx.config.checkpoints_dir, ignore_errors=True)
    return launches


def _checkpoint_checks(ctx, name: str, steps: int) -> dict:
    """The checkpointed REST fit of ``name`` committed a verified step
    dir after each epoch; its commit seconds and bytes."""
    from learningorchestra_tpu_torch.runtime.checkpoint import Checkpointer

    ck_dir = os.path.join(ctx.config.checkpoints_dir, name)
    saved = sorted(int(n) for n in os.listdir(ck_dir) if n.isdigit())
    want = [steps // TRAIN_EPOCHS * (e + 1) for e in range(TRAIN_EPOCHS)]
    ck = Checkpointer(ck_dir)
    if saved != want or ck.latest_step() != steps:
        raise AssertionError(f"{name} committed steps {saved}, want {want}")
    t0 = time.monotonic()
    for step in saved:
        ck.saved_metadata(step)  # re-hashed: raises when corrupt
    verify_s = time.monotonic() - t0
    meta = ctx.catalog.get_metadata(name)
    commits = meta["checkpointCommits"]
    if [c["step"] for c in commits] != want:
        raise AssertionError(f"{name} commits {commits}")
    return {"steps": saved, "checkpointSaveSeconds": [
        c["seconds"] for c in commits], "bytesPerStep": [
        c["bytes"] for c in commits], "verifySecondsAllSteps": verify_s,
        "checkpointCommitSeconds": meta["checkpointCommitSeconds"]}


def _resume_checks(ctx, job, base, fit_params, losses, trained, x,
                   steps: int, launches: dict) -> dict:
    """A fit of 1 epoch, then PATCHed to 2, resumes from its step and
    trains the second epoch exactly as the uninterrupted fit did; again
    after the newest step's payload is bit-flipped (it goes to the
    quarantine and the run restores the step before it). DELETE takes
    the checkpoint dir away."""
    import torch

    ck_dir = os.path.join(ctx.config.checkpoints_dir, "lm_rs")
    per_epoch = steps // TRAIN_EPOCHS
    need = dict.fromkeys(COUNTERS, 0)
    need.update(dict.fromkeys(
        ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
        LM_CONFIG["n_layers"] * per_epoch * TRAIN_ACCUM))
    out = {}
    _, _, ran = job("train", "lm_rs", "lm", "fit",
                    dict(fit_params, epochs=1))
    first = [d["epochRecord"]["loss"] for d in ctx.catalog.get_documents(
        "lm_rs") if "epochRecord" in d]
    if first != losses[:1] or ran != need:
        raise AssertionError(f"lm_rs epoch 1: {first} {ran}")
    for case in ("pipelineResume", "pipelineResumeQuarantined"):
        if case == "pipelineResumeQuarantined":
            # one byte of the newest step's payload flipped, same size
            payload = os.path.join(ck_dir, str(steps), "checkpoint.msgpack")
            with open(payload, "r+b") as f:
                f.seek(os.path.getsize(payload) // 2)
                byte = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([byte[0] ^ 0xFF]))
        n_docs = len(ctx.catalog.get_documents("lm_rs"))
        wall, _, launches[case] = job("train", "lm_rs", None, "fit",
                                      dict(fit_params, epochs=2))
        records = [d["epochRecord"] for d in
                   ctx.catalog.get_documents("lm_rs")[n_docs:]
                   if "epochRecord" in d]
        got = [r["loss"] for r in records]
        if got != losses[1:] or [r["epoch"] for r in records] != [1]:
            raise AssertionError(f"{case}: resumed epochs {records}, want "
                                 f"the uninterrupted fit's {losses[1:]}")
        if launches[case] != need:
            raise AssertionError(f"{case} launched {launches[case]}, want "
                                 f"{need}")
        meta = ctx.catalog.get_metadata("lm_rs")
        out[case] = {"wallSeconds": wall, "losses": got,
                     "epochSeconds": records[0]["epochSeconds"],
                     "stepMs": records[0]["epochSeconds"] / per_epoch * 1e3,
                     "checkpointRestores": meta["checkpointRestores"],
                     "checkpointSaveSeconds": [
                         c["seconds"] for c in meta["checkpointCommits"]]}
        if case == "pipelineResume":
            resumed = ctx.artifacts.load("lm_rs")
            same = all(torch.equal(resumed.params[k], trained.params[k])
                       for k in trained.params)
            ev_r = resumed.evaluate(x, batch_size=TRAIN_BATCH)
            ev_t = trained.evaluate(x, batch_size=TRAIN_BATCH)
            if not same or ev_r != ev_t:
                raise AssertionError(f"the resumed artifact differs from the "
                                     f"uninterrupted one: params equal "
                                     f"{same}, evaluate {ev_r} vs {ev_t}")
            out[case].update(paramsEqual=same, evaluate=ev_r)
            del resumed
        else:
            quarantined = os.listdir(os.path.join(ck_dir, ".quarantine"))
            restored = [r["step"] for r in meta["checkpointRestores"]]
            if not any(q.startswith(f"{steps}-") for q in quarantined) or \
                    restored != [per_epoch]:
                raise AssertionError(f"quarantine {quarantined}, restored "
                                     f"{restored}")
            out[case]["quarantine"] = quarantined
    status, _ = _http(base, "DELETE", "/train/tensorflow/lm_rs")
    if status != 200 or os.path.exists(ck_dir):
        raise AssertionError("DELETE left the checkpoint dir of lm_rs")
    out["deleteRemovedCheckpointDir"] = True
    return out


def _lora_checks(torch, ctx, job, post, base, home, trained,
                 launches) -> dict:
    """The tutorial's LoRA workflow over REST: ingest a second corpus,
    enable_lora, fit the adapters alone, merge_lora, then the tutorial's
    sampled generate on the merged model."""
    import numpy as np

    dx = _domain_windows(np, TRAIN_WINDOWS, TRAIN_SEQ, seed=1)
    csv_path = os.path.join(home, "domain.csv")
    with open(csv_path, "w") as f:
        f.write(",".join(f"t{i}" for i in range(dx.shape[1])) + "\n")
        for row in dx:
            f.write(",".join(map(str, row.tolist())) + "\n")
    post("/dataset/csv", {"datasetName": "domain_corpus",
                          "datasetURI": csv_path})
    _poll(base, "/dataset/csv/domain_corpus")
    out = {}
    out["enableSeconds"], _, launches["loraEnable"] = job(
        "train", "lm_lora", "lm_t", "enable_lora", {"rank": LORA_RANK})
    out["fitWallSeconds"], body, launches["loraFit"] = job(
        "train", "lm_ft", "lm_lora", "fit", {
            "x": "$domain_corpus", "epochs": LORA_EPOCHS,
            "batch_size": LORA_BATCH})
    records = [d["epochRecord"] for d in body["result"]
               if "epochRecord" in d]
    losses = [r["loss"] for r in records]
    steps = LORA_EPOCHS * TRAIN_WINDOWS // LORA_BATCH
    if len(losses) != LORA_EPOCHS or not losses[-1] < losses[0]:
        raise AssertionError(f"the fine-tune's loss did not fall: {losses}")
    want = dict.fromkeys(COUNTERS, 0)
    want.update(dict.fromkeys(
        ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
        LM_CONFIG["n_layers"] * steps))
    if launches["loraFit"] != want:
        raise AssertionError(f"the fine-tune launched {launches['loraFit']}"
                             f", want {want}")
    out["mergeSeconds"], _, launches["loraMerge"] = job(
        "train", "lm_merged", "lm_ft", "merge_lora", {})
    lora = ctx.artifacts.load("lm_lora")
    tuned = ctx.artifacts.load("lm_ft")
    base_equal = all(torch.equal(tuned.params[k], trained.params[k])
                     for k in trained.params)
    adapters = [k for k in tuned.params if ".lora_" in k]
    moved = all(not torch.equal(tuned.params[k], lora.params[k])
                for k in adapters)
    if not base_equal or len(adapters) != 8 * LM_CONFIG["n_layers"] or \
            not moved:
        raise AssertionError(f"base weights equal {base_equal}, adapters "
                             f"{len(adapters)}, all moved {moved}")
    del lora
    merged = ctx.artifacts.load("lm_merged")
    if any(".lora_" in k for k in merged.params):
        raise AssertionError("merge_lora left adapters")
    evals = {}
    for dtype in ("float32", "bfloat16"):
        os.environ["LO_COMPUTE_DTYPE"] = dtype
        for name, model in (("adapted", tuned), ("merged", merged)):
            model._engine = None
            evals[f"{name}{dtype.capitalize()}"] = model.evaluate(
                dx, batch_size=8)
    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    rel = abs(evals["mergedFloat32"]["loss"] - evals["adaptedFloat32"][
        "loss"]) / abs(evals["adaptedFloat32"]["loss"])
    if not rel <= 1e-5:
        raise AssertionError(f"merged vs adapted float32 evaluate: relative "
                             f"{rel} ({evals})")
    out["generateSeconds"], body, launches["loraGenerate"] = job(
        "predict", "lm_gen2", "lm_merged", "generate", TUTORIAL_GENERATE)
    tokens = next(d["result"] for d in body["result"] if "result" in d)
    solo = merged.generate(**TUTORIAL_GENERATE).tolist()
    if tokens != solo:
        raise AssertionError(f"sampled REST generate {tokens} differs from "
                             f"the reloaded merged model's {solo}")
    step_ms = records[-1]["epochSeconds"] / (steps // LORA_EPOCHS) * 1e3
    out.update(losses=losses, epochSeconds=[r["epochSeconds"]
                                            for r in records],
               stepMsEpoch2=step_ms, baseEqual=True, adaptersMoved=True,
               evaluate=evals, mergedVsAdaptedRelFloat32=rel,
               generateTokensEqualSolo=True, generateTokens=len(solo[0]))
    return out


# the LM options phase: the tutorial LM with Mixtral-8x7B's router (8
# experts, 2 a token) over the JAX package's ungated GELU experts
MOE_CONFIG = dict(LM_CONFIG, n_experts=8, moe_k=2)
BEAM_PROMPT, BEAMS = 1024, 4
REMAT_DROPOUT = 0.1


def _moe_rest_fit(torch, base, ctx, x, post) -> dict:
    """(a) The MoE LM created and fitted over REST; the job's launches,
    losses and epoch seconds."""
    from learningorchestra_tpu_torch.ops import attention as attn

    ctx.artifacts.save({"tokens": x}, "corpus", "function/python")
    post("/model/tensorflow", {
        "modelName": "moe", "modulePath": "learningorchestra_tpu.models",
        "class": "LanguageModel", "classParameters": MOE_CONFIG})
    _poll(base, "/model/tensorflow/moe")
    _reset_launches(attn)
    t0 = time.monotonic()
    post("/train/tensorflow", {
        "name": "moe_t", "modelName": "moe", "method": "fit",
        "methodParameters": {"x": "$corpus.tokens",
                             "batch_size": TRAIN_BATCH,
                             "epochs": TRAIN_EPOCHS,
                             "grad_accum": TRAIN_ACCUM}})
    _poll(base, "/train/tensorflow/moe_t")
    wall = time.monotonic() - t0
    launches = _launches(attn)
    records = [d["epochRecord"] for d in ctx.catalog.get_documents("moe_t")
               if "epochRecord" in d]
    return {"launches": launches, "wallSeconds": wall,
            "losses": [r["loss"] for r in records],
            "epochSeconds": [r["epochSeconds"] for r in records]}


def _moe_checks(torch, lm, x) -> dict:
    """(a) The trained MoE LM's load-balance term and dropped copies per
    layer on one micro-batch of the fit's shape (bf16), and one optimizer
    step run twice from one state: the params must come out bit for
    bit the same."""
    eng = lm._get_engine()
    params = lm._master_params()
    micro = torch.from_numpy(x[:TRAIN_BATCH // TRAIN_ACCUM]).to(
        lm.device).long()
    blocks = [getattr(lm.module, f"layer_{i}").moe
              for i in range(MOE_CONFIG["n_layers"])]
    for moe in blocks:
        moe.stats = {}
    with torch.inference_mode():
        _, aux = torch.func.functional_call(
            lm.module, eng._cast(params), (micro,), {"return_aux": True})
    dropped = [moe.stats["dropped"] / moe.stats["copies"] for moe in blocks]
    for moe in blocks:
        moe.stats = None
    aux = float(aux)
    if not aux > 0:
        raise AssertionError(f"MoE load-balance term {aux}")
    saved = {k: p.detach().clone() for k, p in params.items()}
    batch = eng._to_device(next(iter(lm._batcher(
        x[:TRAIN_BATCH], TRAIN_BATCH).epoch(0))), lm.device)
    after = []
    for _ in range(2):
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])
        eng._train_step_body(eng.init_state(params), batch, 0)
        after.append({k: p.detach().clone() for k, p in params.items()})
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(saved[k])
    apart = [k for k in params
             if not torch.equal(after[0][k], after[1][k])]
    if apart:
        raise AssertionError(f"a repeated MoE step moved {len(apart)} "
                             f"tensors differently: {apart[:4]}")
    del saved, after
    return {"auxSum": aux, "droppedCopyShareByLayer": dropped,
            "repeatStepBitIdentical": True}


def _remat_checks(torch, state, x) -> tuple:
    """(c) 2 bf16 steps of the dense tutorial fit with dropout under each
    remat policy from one state, then one float32 micro-step's gradients
    under each against no remat. Returns (report, launches by path)."""
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn

    config = dict(LM_CONFIG, dropout=REMAT_DROPOUT)
    need = LM_CONFIG["n_layers"] * TRAIN_ACCUM * 2
    report, paths, grads = {}, {}, {}
    for policy in ("none", "dots", "full"):
        lm = LanguageModel(**config, remat=policy, device="cuda")
        lm.set_params(state)
        lm._set_grad_accum(TRAIN_ACCUM)
        eng = lm._get_engine()
        tstate = eng.init_state(lm._master_params())
        batches = [eng._to_device(b, lm.device) for b in
                   lm._batcher(x[:2 * TRAIN_BATCH], TRAIN_BATCH).epoch(0)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(attn)
        step_ms, losses = [], []
        for batch in batches:
            t0 = time.monotonic()
            s, c = eng._train_step_body(tstate, batch, 0)["loss"]
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
            losses.append(float(s) / float(c))
        ran = _launches(attn)
        fwd = need * (1 if policy == "none" else 2)
        want = dict.fromkeys(COUNTERS, 0)
        want.update(flash_fwd_sm90=fwd, flash_bwd_dq_sm90=need,
                    flash_bwd_dkv_sm90=need)
        if ran != want:
            raise AssertionError(f"remat {policy}: launches {ran}, want "
                                 f"{want} (the recompute relaunches the "
                                 f"forward)")
        report[policy] = {"stepMs": step_ms, "losses": losses,
                          "maxMemoryAllocatedBytes":
                              torch.cuda.max_memory_allocated()}
        paths[f"lmOptionsRemat{policy.capitalize()}"] = ran
        del lm, eng, tstate, batches
        # one float32 micro-step of 2 windows, dropout on
        os.environ["LO_COMPUTE_DTYPE"] = "float32"
        try:
            lm = LanguageModel(**config, remat=policy, device="cuda")
            lm.set_params(state)
            eng = lm._get_engine()
            g, _ = eng._micro_grads(lm._master_params(), eng._to_device(
                {"x": x[:2]}, lm.device), 0)
            grads[policy] = g
            del lm, eng
        finally:
            os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    first = {p: r["losses"][0] for p, r in report.items()}
    if len(set(first.values())) != 1:
        raise AssertionError(f"the first step's loss differs by remat "
                             f"policy: {first}")
    peaks = [report[p]["maxMemoryAllocatedBytes"]
             for p in ("none", "dots", "full")]
    if not peaks[0] > peaks[1] > peaks[2]:
        raise AssertionError(f"peak memory none/dots/full {peaks} does not "
                             f"fall")
    for policy in ("dots", "full"):
        rel = {k: ((grads[policy][k] - grads["none"][k]).norm()
                   / grads["none"][k].norm().clamp_min(1e-30)).item()
               for k in grads["none"]}
        worst = max(rel, key=rel.get)
        if not rel[worst] <= 1e-4:
            raise AssertionError(f"remat {policy} float32 gradient of "
                                 f"{worst}: relative L2 {rel[worst]}")
        report[policy]["f32GradRelL2VsNone"] = {"max": rel[worst],
                                                "worst": worst}
    return report, paths


def _fuse_tree(tree, qkv: bool):
    """The fused layout of a split flax tree: gate/up concatenated into
    ``gate_up`` and, with ``qkv``, q/k/v into ``qkv_proj``."""
    import numpy as np

    out = dict(tree)
    for name, layer in tree.items():
        if not name.startswith("layer_"):
            continue
        layer = dict(layer)
        if qkv:
            attn = dict(layer["attn"])
            attn["qkv_proj"] = {"kernel": np.concatenate(
                [attn.pop(p)["kernel"]
                 for p in ("q_proj", "k_proj", "v_proj")], axis=1)}
            layer["attn"] = attn
        mlp = dict(layer["mlp"])
        mlp["gate_up"] = {"kernel": np.concatenate(
            [mlp.pop("gate")["kernel"], mlp.pop("up_proj")["kernel"]],
            axis=1)}
        layer["mlp"] = mlp
        out[name] = layer
    return out


def _fused_checks(torch, x) -> tuple:
    """(d) The dense tutorial LM with fused projections (GQA: gate_up
    only) and its 8-kv-head variant (qkv_proj too), each built from its
    split tree's weights: float32 logits of a 1024-token window against
    the split model's, and one bf16 fit step."""
    import numpy as np

    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn

    report, paths = {}, {}
    window = torch.from_numpy(x[:1, :BEAM_PROMPT]).to("cuda").long()
    for name, config, qkv in (("gqa", LM_CONFIG, False),
                              ("mha", dict(LM_CONFIG, n_kv_heads=8), True)):
        tree = weights.init_params(config, seed=0)
        split = LanguageModel(**config, device="cuda")
        split.set_params(weights.params_from_flax(tree))
        fused = LanguageModel(**config, fused_proj=True, device="cuda")
        fused.set_params(weights.params_from_flax(_fuse_tree(tree, qkv)))
        keys = set(fused.params)
        if ("layer_0.attn.qkv_proj.weight" in keys) != qkv or \
                "layer_0.mlp.gate_up.weight" not in keys:
            raise AssertionError(f"fused {name} tree: {sorted(keys)[:8]}")
        with torch.inference_mode():
            got, want = fused.module(window), split.module(window)
        err = (got - want).abs().max().item()
        if not bool(torch.isfinite(got).all()) or not err <= 1e-4:
            raise AssertionError(f"fused {name} logits vs split: {err}")
        del split
        _reset_launches(attn)
        hist = fused.fit(x[:TRAIN_BATCH], batch_size=TRAIN_BATCH, epochs=1,
                         grad_accum=TRAIN_ACCUM, shuffle=False).history
        ran = _launches(attn)
        need = config["n_layers"] * TRAIN_ACCUM
        want_ran = dict.fromkeys(COUNTERS, 0)
        want_ran.update(flash_fwd_sm90=need, flash_bwd_dq_sm90=need,
                        flash_bwd_dkv_sm90=need)
        if ran != want_ran or not np.isfinite(hist["loss"][0]):
            raise AssertionError(f"fused {name} fit step: {ran} "
                                 f"{hist['loss']}")
        report[name] = {"logitsMaxAbsErrVsSplit": err,
                        "fitStepLoss": hist["loss"][0],
                        "fitStepSeconds": hist["epochSeconds"][0]}
        paths[f"lmOptionsFused{name.capitalize()}Fit"] = ran
        del fused
    return report, paths


def _seq_logprob(torch, lm, seq, prompt_len: int) -> float:
    """The model's summed log-prob of ``seq``'s continuation, token 0
    masked (float32), as beam search ranks it."""
    from learningorchestra_tpu_torch.models.transformer import NEG_INF

    tokens = torch.tensor([seq], device=lm.device)
    with torch.inference_mode():
        logits = lm.module(tokens)[0].float()
        logits[:, 0] = NEG_INF
        lp = torch.log_softmax(logits, dim=-1)
        pos = torch.arange(prompt_len, len(seq), device=lm.device)
        return float(lp[pos - 1, tokens[0, pos]].double().sum())


def _moe_serving(torch, base, ctx, lm, post) -> tuple:
    """(f) The trained MoE LM on a fresh slot and a fresh paged session,
    float32: the serving phase's 4 prompts sent one after another (each
    step's batch fixed by the order), then all 4 at once for the rates.
    (g) The lane overrun of a retired stream on a paged session."""
    import numpy as np

    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.serving import (
        PagedLMServingSession, _Request)

    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, LM_CONFIG["vocab_size"],
                                             size=n)]
               for n in PROMPT_LENS]
    solos = [[int(t) for t in lm.generate(
        [p], max_new_tokens=NEW_TOKENS)[0][len(p):]] for p in prompts]
    report, paths, tokens = {}, {}, {}
    for kind, extra in (("slot", {}),
                        ("paged", {"kv": "paged", "pageLen": PAGE_LEN})):
        post("/serve/moe_t", dict({"type": "lm", "maxSlots": 4,
                                   "cacheLen": 2048, "temperature": 0.0},
                                  **extra))
        _reset_launches(attn)
        out = [_http(base, "POST", "/serve/moe_t/predict",
                     {"prompt": p, "maxNewTokens": NEW_TOKENS})
               for p in prompts]
        ran = _launches(attn)
        tokens[kind] = _round_tokens(f"moe {kind}", out, NEW_TOKENS)
        want = dict.fromkeys(COUNTERS, 0)
        want["flash_fwd_tf32x3"] = LM_CONFIG["n_layers"] * len(prompts)
        if ran != want:
            raise AssertionError(f"MoE {kind} prefills launched {ran}, "
                                 f"want {want}")
        paths[f"lmOptionsMoe{kind.capitalize()}"] = ran
        out, walls, wall = _predict_round(base, "moe_t", prompts,
                                          NEW_TOKENS)
        _round_tokens(f"moe {kind} concurrent", out, NEW_TOKENS)
        report[kind] = {"concurrent": {
                            "wallSeconds": wall,
                            **_round_rates(out, walls, NEW_TOKENS)},
                        "sequentialVsSolo": _agreement(tokens[kind], solos)}
        status, _ = _http(base, "DELETE", "/serve/moe_t")
        if status != 200:
            raise AssertionError(f"delete MoE {kind} session: {status}")
    report["pagedVsSlot"] = _agreement(tokens["paged"], tokens["slot"])

    # (g) a long stream retires past its first page while only a short
    # one lives: the next steps gather one page, and the retired lane's
    # column (kept, as the JAX session keeps it) lies past that slice
    sess = PagedLMServingSession(
        "lane", ctx, lm, slots=4, cache_len=2048, temperature=0.0,
        top_k=None, top_p=None, page_len=PAGE_LEN,
        n_pages=4 * 2048 // PAGE_LEN + 1)
    long_req = _Request({"prompt": prompts[0][:PAGE_LEN + 4],
                         "maxNewTokens": 3})
    short_req = _Request({"prompt": prompts[1][:3], "maxNewTokens": 8})
    sess._queue.extend([long_req, short_req])
    overruns = 0
    while sess._queue or sess._active_slots():
        if sess._active_slots() == [1]:
            overruns += int(sess._col[0]) // PAGE_LEN >= sess._gather_width()
        sess._serve_once()
    torch.cuda.synchronize()
    if not overruns or long_req.error or short_req.error or \
            [len(r.result["tokens"]) for r in (long_req, short_req)] != [3, 8]:
        raise AssertionError(f"lane overrun: {overruns} overrunning steps, "
                             f"errors {long_req.error} {short_req.error}")
    report["laneOverrun"] = {"overrunSteps": overruns, "error": None}
    return report, paths


def lm_options_phase(torch, log, home, yard):
    """The LanguageModel's options on the card (the ``lmOptions`` line).
    (a) The MoE tutorial LM (8 experts, k 2) created and fitted over REST
    in bf16 on the train phase's windows: the loss falls, the
    load-balance term is positive, 8 layers x 16 micro-batches of each
    wgmma kernel and nothing else, and one step repeated from one state
    gives the same bits; step time, idle share over 2 profiled steps,
    dropped copies per layer, peak memory. (b) Its float32 gradient
    micro-step through the split-TF32 kernels against the dense path
    (1e-4 relative L2 per tensor). (c) Remat none/dots/full under dropout
    0.1 on the dense LM: equal first-step losses, falling peak memory,
    the forward launched twice under remat, float32 gradients within
    1e-4 of no remat. (d) Fused projections, GQA and 8 kv heads, against
    their split trees. (e) Beam search (1 and 4 beams, 32 tokens after
    1024) over REST on the trained MoE LM: 1 beam equals greedy, 4 beams
    score at least greedy's log-prob. (f, g) MoE serving on the slot and
    paged sessions, and the paged lane overrun. Returns the launches of
    each path."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    x = yard["x"]
    phase_t0 = time.monotonic()
    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    paths, report = {}, {"config": MOE_CONFIG}

    def post(path, body, want=201):
        status, out = _http(base, "POST", path, body)
        if status != want:
            raise AssertionError(f"POST {path}: {status} {out}")
        return out

    try:
        # (a) the MoE fit over REST
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fit = _moe_rest_fit(torch, base, ctx, x, post)
        peak = torch.cuda.max_memory_allocated()
        losses = fit["losses"]
        steps = TRAIN_EPOCHS * TRAIN_WINDOWS // TRAIN_BATCH
        need = LM_CONFIG["n_layers"] * steps * TRAIN_ACCUM
        want = dict.fromkeys(COUNTERS, 0)
        want.update(flash_fwd_sm90=need, flash_bwd_dq_sm90=need,
                    flash_bwd_dkv_sm90=need)
        if fit["launches"] != want:
            raise AssertionError(f"MoE fit launched {fit['launches']}, "
                                 f"want {want}")
        if len(losses) != TRAIN_EPOCHS or not all(np.isfinite(losses)) or \
                not losses[1] < losses[0]:
            raise AssertionError(f"MoE fit losses {losses}")
        paths["lmOptionsMoeFit"] = fit["launches"]
        trained = ctx.artifacts.load("moe_t")
        trained._set_grad_accum(TRAIN_ACCUM)
        epoch2 = fit["epochSeconds"][1]
        report["moeFit"] = {
            "windows": TRAIN_WINDOWS, "seq": TRAIN_SEQ,
            "batch": TRAIN_BATCH, "gradAccum": TRAIN_ACCUM,
            "epochs": TRAIN_EPOCHS, "computeDtype": "bfloat16",
            "losses": losses, "epochSeconds": fit["epochSeconds"],
            "jobWallSeconds": fit["wallSeconds"],
            "stepMs": epoch2 / (steps // TRAIN_EPOCHS) * 1e3,
            "trainTokensPerSec": TRAIN_WINDOWS * TRAIN_SEQ / epoch2,
            "maxMemoryAllocatedBytes": peak,
            **_moe_checks(torch, trained, x),
            "profile": _profiled_window(torch, trained, x)}

        # (b) the float32 gradient micro-step, kernels against dense
        init = weights.params_from_flax(weights.init_params(MOE_CONFIG,
                                                            seed=0))
        grad = _grads_vs_dot(torch, "lmOptionsMoeFloat32Grad", MOE_CONFIG,
                             init, "float32", 1e-4, x[:2])
        paths["lmOptionsMoeFloat32Grad"] = grad["launches"]
        report["moeFloat32GradRelL2VsDot"] = grad["relL2VsDot"]
        del init

        # (c) remat, (d) fused projections
        state = weights.params_from_flax(weights.init_params(LM_CONFIG,
                                                             seed=0))
        report["remat"], ran = _remat_checks(torch, state, x)
        paths.update(ran)
        del state
        report["fused"], ran = _fused_checks(torch, x)
        paths.update(ran)

        # (e) beam search over REST on the trained MoE LM, float32
        prompt = [int(t) for t in x[2, :BEAM_PROMPT]]
        beams = {}
        for n in (1, BEAMS):
            _reset_launches(attn)
            post("/predict/tensorflow", {
                "name": f"moe_beam{n}", "modelName": "moe_t",
                "method": "generate", "methodParameters": {
                    "prompt": [prompt], "max_new_tokens": NEW_TOKENS,
                    "num_beams": n}})
            _poll(base, f"/predict/tensorflow/moe_beam{n}")
            ran = _launches(attn)
            want = dict.fromkeys(COUNTERS, 0)
            want["flash_fwd_tf32x3"] = LM_CONFIG["n_layers"]
            if ran != want:
                raise AssertionError(f"beam {n} launched {ran}, want {want}")
            paths[f"lmOptionsBeam{n}"] = ran
            seq = next(d["result"] for d in ctx.catalog.get_documents(
                f"moe_beam{n}") if "result" in d)[0]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            trained.generate([prompt], max_new_tokens=NEW_TOKENS,
                             num_beams=n)
            torch.cuda.synchronize()
            beams[n] = {"tokens": seq[len(prompt):],
                        "logProb": _seq_logprob(torch, trained, seq,
                                                len(prompt)),
                        "msPerToken": (time.monotonic() - t0) * 1e3
                        / NEW_TOKENS}
        greedy = [int(t) for t in trained.generate(
            [prompt], max_new_tokens=NEW_TOKENS)[0][len(prompt):]]
        if beams[1]["tokens"] != greedy:
            raise AssertionError("1 beam differs from greedy generate")
        # the two sums come from one float32 forward each; beam search
        # ranked them on its decode steps' logits
        if not beams[BEAMS]["logProb"] >= beams[1]["logProb"] - 1e-4 * abs(
                beams[1]["logProb"]):
            raise AssertionError(f"{BEAMS} beams scored "
                                 f"{beams[BEAMS]['logProb']}, below greedy's "
                                 f"{beams[1]['logProb']}")
        report["beam"] = {
            "prompt": BEAM_PROMPT, "newTokens": NEW_TOKENS,
            "beam1EqualsGreedy": True,
            **{f"beams{n}": {k: v for k, v in b.items() if k != "tokens"}
               for n, b in beams.items()},
            "beamTokensEqualGreedy": beams[BEAMS]["tokens"] == greedy}

        # (f) MoE serving, (g) the lane overrun
        served, ran = _moe_serving(torch, base, ctx, trained, post)
        report["serving"] = served
        paths.update(ran)
    finally:
        server.stop()
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    report["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("lmOptions " + json.dumps(report))
    return paths


def classifier_phase(torch, log, home, yard):
    """The tutorial's TextClassifier on the card in bf16 with
    ``attention="flash"``: a 3-epoch fit of 1024 rows of 512 tokens
    (the non-causal sm90 kernels at head_dim 32, 4 layers x 24 steps of
    each and nothing else), evaluate, predict (probability rows that sum
    to 1), the artifact's round trip, one float32 gradient micro-step
    through the split-TF32 kernels against the dense path, and ``POST
    /model`` of the tutorial's body. Returns the kernel launches of the
    fit and of the gradient step; leaves the classifier and its rows in
    ``yard`` for the serving plane's bucketed phase."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models.encoder import TextClassifier
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime.data import MASK_KEY
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    x, y = _marker_rows(np, CLF_ROWS, CLF_SEQ, CLF_CONFIG["vocab_size"],
                        seed=0)
    clf = TextClassifier(**CLF_CONFIG, attention="flash", device="cuda")
    steps = CLF_EPOCHS * CLF_ROWS // CLF_BATCH
    _reset_launches(attn)
    t0 = time.monotonic()
    hist = clf.fit(x, y, batch_size=CLF_BATCH, epochs=CLF_EPOCHS).history
    fit_s = time.monotonic() - t0
    launches = _launches(attn)
    losses = hist["loss"]
    want = dict.fromkeys(COUNTERS, 0)
    want.update(dict.fromkeys(
        ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
        CLF_CONFIG["n_layers"] * steps))
    if launches != want:
        raise AssertionError(f"the classifier's fit launched {launches}, "
                             f"want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the classifier's loss did not fall: {losses}")
    evaluated = clf.evaluate(x, y, batch_size=CLF_BATCH)
    probs = clf.predict(x, batch_size=CLF_BATCH)
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    if probs.shape != (CLF_ROWS, 2) or not row_err <= 1e-5:
        raise AssertionError(f"predict rows: shape {probs.shape}, max |sum "
                             f"- 1| {row_err}")
    ctx = ServiceContext(Config(home=home), device="cuda")
    ctx.artifacts.save(clf, "clf_t", "train/tensorflow")
    loaded = ctx.artifacts.load("clf_t")
    if not np.array_equal(loaded.predict(x, batch_size=CLF_BATCH), probs):
        raise AssertionError("the reloaded classifier predicts otherwise")

    # float32: one micro-step of 8 rows through the split-TF32 kernels
    # (non-causal, head_dim 32) against the dense path
    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    state = {k: t.detach().cpu() for k, t in clf.params.items()}
    grads, grad_launches = {}, {}
    for impl in ("flash", "dot"):
        model = TextClassifier(**CLF_CONFIG, attention=impl, device="cuda")
        model.set_params(state)
        eng = model._get_engine()
        batch = eng._to_device({"x": x[:8], "y": y[:8],
                                MASK_KEY: np.ones(8, np.float32)},
                               model.device)
        _reset_launches(attn)
        grads[impl], _ = eng._micro_grads(
            dict(model.module.named_parameters()), batch, 0)
        grad_launches[impl] = _launches(attn)
        del model, eng
    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    want_f32 = dict.fromkeys(COUNTERS, 0)
    want_f32.update(dict.fromkeys(
        ("flash_fwd_tf32x3", "flash_bwd_dq_tf32x3", "flash_bwd_dkv_tf32x3"),
        CLF_CONFIG["n_layers"]))
    if grad_launches != {"flash": want_f32,
                         "dot": dict.fromkeys(COUNTERS, 0)}:
        raise AssertionError(f"the float32 gradient step launched "
                             f"{grad_launches}")
    rel = {k: ((grads["flash"][k] - grads["dot"][k]).norm()
               / grads["dot"][k].norm().clamp_min(1e-30)).item()
           for k in grads["dot"]}
    worst = max(rel, key=rel.get)
    if not rel[worst] <= 1e-4:
        raise AssertionError(f"classifier float32 gradient of {worst}: "
                             f"relative L2 {rel[worst]} against dot")

    server = RestServer(port=0, context=ctx).start()
    try:
        body = {"modelName": "clf", "modulePath":
                "learningorchestra_tpu.models", "class": "TextClassifier",
                "classParameters": CLF_CONFIG}
        status, out = _http(server.base_url, "POST", "/model/tensorflow",
                            body)
        if status != 201:
            raise AssertionError(f"POST /model TextClassifier: {status} "
                                 f"{out}")
        _poll(server.base_url, "/model/tensorflow/clf")
    finally:
        server.stop()
        ctx.close()
    yard.update(clf=clf, clfRows=x)
    log.append("classifier " + json.dumps({
        "config": CLF_CONFIG, "attention": "flash", "rows": CLF_ROWS,
        "seq": CLF_SEQ, "batch": CLF_BATCH, "epochs": CLF_EPOCHS,
        "optimizerSteps": steps, "computeDtype": "bfloat16",
        "history": hist, "fitSeconds": fit_s, "launches": launches,
        "stepMsEpoch3": hist["epochSeconds"][-1] / (steps // CLF_EPOCHS)
        * 1e3,
        "tokensPerSecEpoch3": CLF_ROWS * CLF_SEQ / hist["epochSeconds"][-1],
        "evaluate": evaluated, "predictRowSumMaxErr": row_err,
        "artifactRoundTripEqual": True,
        "f32GradRelL2VsDot": {"max": rel[worst], "worst": worst},
        "f32GradLaunches": grad_launches["flash"],
        "restModelCreated": True}))
    return {"classifierFit": launches,
            "classifierFloat32Grad": grad_launches["flash"]}

# the serving plane's draft: a small LM with the tutorial LM's vocabulary
# and context (head_dim 64), fitted in the phase in bf16 on the train
# phase's windows
DRAFT_CONFIG = dict(vocab_size=32000, d_model=256, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=0, max_len=2048, sliding_window=1024,
                    rope_base=10000.0)
DRAFT_LR, DRAFT_BATCH, DRAFT_MAX_STEPS = 1e-3, 16, 8
SPEC_K = 4
# the prompt of random ids, off the successor pattern
OFF_PATTERN_PROMPT = 1200
# decode cadence under a burst: two in-flight streams of 64 tokens after
# 256-token prompts, and two 1500-token prompts arriving mid-stream
CADENCE_PROMPT, CADENCE_NEW, BURST_PROMPT = 256, 64, 1500
# rows a bucketed predict burst sends, one burst after another, then the
# rows of three concurrent clients
BUCKET_BURSTS, BUCKET_CLIENTS = ((1, 1), (3, 4), (5, 8)), (2, 3, 3)


def _distinct_windows(x, n: int, skip=()) -> list:
    """Indices of ``n`` windows of ``x`` with pairwise distinct first ids
    (and none of ``skip``'s): the successor stream repeats every 63 ids,
    so two windows share a prefix exactly when they start alike."""
    seen = {int(x[i, 0]) for i in skip}
    out = []
    for i in range(len(x)):
        if int(x[i, 0]) not in seen:
            seen.add(int(x[i, 0]))
            out.append(i)
        if len(out) == n:
            return out
    raise AssertionError(f"fewer than {n} distinct windows")


def _fit_draft(x, target_loss: float):
    """The draft LM from ``init_params(DRAFT_CONFIG, 0)``, fitted in bf16
    an epoch (4 steps of 16 windows) at a time until its epoch loss is
    below ``target_loss`` or it has taken DRAFT_MAX_STEPS steps. Returns
    the model, its epoch losses and the launches of its fit."""
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    draft = LanguageModel(**DRAFT_CONFIG, device="cuda")
    draft.set_params(weights.params_from_flax(
        weights.init_params(DRAFT_CONFIG, seed=0)))
    draft.compile({"kind": "adamw", "learning_rate": DRAFT_LR})
    per_epoch = len(x) // DRAFT_BATCH
    losses = []
    _reset_launches(attn)
    while len(losses) * per_epoch < DRAFT_MAX_STEPS:
        hist = draft.fit(x, batch_size=DRAFT_BATCH, epochs=1,
                         grad_accum=1).history
        losses.append(hist["loss"][0])
        if losses[-1] < target_loss:
            break
    launches = _launches(attn)
    steps = len(losses) * per_epoch
    want = dict.fromkeys(COUNTERS, 0)
    want.update(dict.fromkeys(
        ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
        DRAFT_CONFIG["n_layers"] * steps))
    if launches != want or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"the draft's fit launched {launches} (want "
                             f"{want}), losses {losses}")
    return draft, losses, steps, launches


def _spec_expectation(news, k: int) -> float:
    """Accepted drafts per verify step if every draft were accepted: a
    stream of ``n`` tokens takes its first from the prefill and the rest
    in ceil((n - 1) / (k + 1)) rounds, the last one clamped at its end."""
    rounds = [-(-(n - 1) // (k + 1)) for n in news]
    return sum(n - 1 - r for n, r in zip(news, rounds)) / sum(rounds)


def _timed_calls(torch, session, names) -> dict:
    """Wraps each of ``session``'s step functions named in ``names`` to
    record its milliseconds, the card synchronized at its end (the
    session reads each result to the host right after anyway). Returns
    the lists it fills, by name."""
    times = {}
    for name in names:
        inner = getattr(session, name)
        times[name] = []

        def timed(*args, _inner=inner, _into=times[name]):
            t = time.monotonic()
            out = _inner(*args)
            torch.cuda.synchronize()
            _into.append((time.monotonic() - t) * 1e3)
            return out

        setattr(session, name, timed)
    return times


# the report's key of each timed step function
_CALL_KEYS = {"_verify": "verifyMsP50", "_draft_propose": "proposeMsP50",
              "_pstep": "stepMsP50"}


def _prefix_held(session) -> int:
    """Page references the session's prefix cache holds itself: an idle
    pool has all its pages free but these."""
    with session.prefix._lock:
        return sum(len(e["held"]) for e in session.prefix._entries.values())


def _p50(values) -> float:
    values = sorted(values)
    return values[(len(values) - 1) // 2]


def _cadence(base, ctx, body, streams, burst, want) -> dict:
    """Two streams decode CADENCE_NEW tokens while two 1500-token prompts
    arrive, on a fresh session of ``body``. The decode rounds are timed
    on the session's own thread; returns the in-flight streams' largest
    and median gap between rounds that gave them a token."""
    session_name = "lm"
    _create(base, session_name, body)
    session = ctx.serving._sessions[session_name]
    times = {len(p): [] for p in streams}
    inner = session._decode_round

    def timed(active):
        lens = [len(session._slot_req[s].payload["prompt"]) for s in active]
        inner(active)
        now = time.monotonic()
        for n in lens:
            if n in times:
                times[n].append(now)

    session._decode_round = timed
    out = [None] * 4
    prompts = list(streams) + list(burst)
    news = [CADENCE_NEW] * len(streams) + [1] * len(burst)

    def client(i):
        out[i] = _http(base, "POST", f"/serve/{session_name}/predict",
                       {"prompt": prompts[i], "maxNewTokens": news[i]})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(4)]
    for t in threads[:2]:
        t.start()
    deadline = time.monotonic() + 120
    while min(len(v) for v in times.values()) < 8:
        if time.monotonic() > deadline:
            raise AssertionError("cadence: the streams never decoded")
        time.sleep(0.002)
    burst_at = time.monotonic()
    for t in threads[2:]:
        t.start()
    for t in threads:
        t.join(timeout=600)
    _http(base, "DELETE", f"/serve/{session_name}")
    for i, result in enumerate(out):
        if result is None or result[0] != 200:
            raise AssertionError(f"cadence predict {i}: {result}")
        if result[1]["tokens"] != want[i]:
            raise AssertionError(f"cadence predict {i} differs from solo")
    gaps = sorted((b - a) * 1e3 for v in times.values()
                  for a, b in zip(v, v[1:]) if b > burst_at)
    return {"mode": "disagg" if body.get("disagg") else "fused",
            "roundsAfterBurst": len(gaps),
            "maxGapMs": gaps[-1], "p50GapMs": gaps[(len(gaps) - 1) // 2],
            "tokensEqualSolo": True}


def serving_plane_phase(torch, log, home, yard):
    """Speculative decoding, disaggregated prefill/decode and bucketed
    predict over REST on the card (the ``servingPlane`` line). The
    target is the train phase's LM, served in float32 (prefills on
    flash_fwd_tf32x3); the draft a 2-layer LM of width 256 fitted here in
    bf16 (the sm90 kernels). Prompts: 1100/1234/1367/1500 tokens of the
    successor windows, where the draft mostly agrees with the target,
    and 1200 random ids, where it mostly does not; 32 greedy tokens each
    on ``maxSlots`` 4, 16-token pages. (a) The target as its own draft,
    specK 4: every stream equals solo; acceptance recorded against its
    end-of-stream bound. (b) disagg + spec with the small draft: every
    stream equals solo, mode colocated, one handoff a request, an empty
    handoff queue, roles {prefill, decode, draft}, 8 flash_fwd_tf32x3
    launches a target prefill and 2 a draft prefill and none in any
    verify or propose step, the pool back to the prefix cache's holds
    after delete; TTFT, decode tokens/s against a plain paged session and
    the draft's ms a round recorded. (c) ``kv_page_handoff:1``: one 429,
    no page leaked, the retry 200; latched: three 429s, ``mode``
    fused-degraded, later requests equal solo, the pool drained. (d) Two
    streams decoding while two 1500-token prompts arrive, fused and
    disaggregated: the largest and median gap between their tokens,
    tokens equal solo. (e) int8 KV with the self-draft: every request
    200, agreement with the exact tokens recorded. (f) The classifier
    phase's TextClassifier as ``type: "predict"``: bursts of 1, 3 and 5
    rows in buckets 1, 4 and 8, then 3 concurrent clients; every row
    within 1e-5 of a direct ``predict`` of its padded bucket, 4 layers x
    predict calls of flash_fwd_sm90 and nothing else. Returns the launches
    of the draft's fit, of (b)'s measured round and of (f)."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services import faults
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    t0 = time.monotonic()
    x, target = yard["x"], yard["lm"]
    draft, draft_losses, draft_steps, fit_launches = _fit_draft(
        x, yard["losses"][1])
    report: dict = {
        "draftConfig": DRAFT_CONFIG, "specK": SPEC_K,
        "draftFit": {"steps": draft_steps, "losses": draft_losses,
                     "targetEpoch2Loss": yard["losses"][1],
                     "belowTarget": draft_losses[-1] < yard["losses"][1],
                     "learningRate": DRAFT_LR, "launches": fit_launches}}
    ctx = ServiceContext(Config(home=home), device="cuda")
    ctx.artifacts.save(target, "lm", "train/tensorflow")
    ctx.artifacts.save(draft, "draft", "train/tensorflow")
    rng = np.random.default_rng(3)
    measured = _distinct_windows(x, len(PROMPT_LENS))
    warm = _distinct_windows(x, len(PROMPT_LENS), skip=measured)
    prompts = [[int(t) for t in x[i, :n]]
               for i, n in zip(measured, PROMPT_LENS)]
    prompts.append([int(t) for t in rng.integers(
        1, LM_CONFIG["vocab_size"], size=OFF_PATTERN_PROMPT)])
    first_use = [[int(t) for t in x[i, 7:7 + n]]
                 for i, n in zip(warm, PROMPT_LENS)]

    def solo(p, new=NEW_TOKENS):
        return [int(t) for t in
                target.generate([p], max_new_tokens=new)[0][len(p):]]

    solos = [solo(p) for p in prompts]
    draft_solos = [[int(t) for t in draft.generate(
        [p], max_new_tokens=NEW_TOKENS)[0][len(p):]] for p in prompts]
    report["draftVsTargetSolo"] = _agreement(draft_solos, solos)
    paged = {"type": "lm", "kv": "paged", "maxSlots": 4, "cacheLen": 2048,
             "pageLen": PAGE_LEN, "temperature": 0.0}
    spec_bound = _spec_expectation([NEW_TOKENS] * len(prompts), SPEC_K)
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    try:
        # (a) the target as its own draft
        _create(base, "lm", dict(paged, draft="lm", specK=SPEC_K))
        calls = _timed_calls(torch, ctx.serving._sessions["lm"],
                             ("_verify", "_draft_propose"))
        out, walls, wall = _predict_round(base, "lm", prompts)
        _diverges("self-draft spec", _round_tokens("self-draft spec", out),
                  solos)
        stats = _http(base, "GET", "/serve/lm")[1]
        per_step = stats["spec"]["acceptedTokensPerStep"]
        report["a"] = {"tokensEqualSolo": True, "spec": stats["spec"],
                       **{_CALL_KEYS[k]: _p50(v) for k, v in calls.items()},
                       "fullAcceptanceBound": spec_bound,
                       "shortfallBeyondClamp": spec_bound - per_step,
                       "wallSeconds": wall, **_round_rates(out, walls)}
        _http(base, "DELETE", "/serve/lm")

        # (b) a plain paged session, then disagg + spec with the draft,
        # each after a first-use round
        rates = {}
        for name, extra in (("paged", {}),
                            ("disaggSpec", {"disagg": True,
                                            "draft": "draft",
                                            "specK": SPEC_K})):
            resp = _create(base, "lm", dict(paged, **extra))
            session = ctx.serving._sessions["lm"]
            _round_tokens(f"{name} first use",
                          _predict_round(base, "lm", first_use)[0])
            calls = _timed_calls(torch, session, (
                "_verify", "_draft_propose") if extra else ("_pstep",))
            _reset_launches(attn)
            out, walls, wall = _predict_round(base, "lm", prompts)
            launches = _launches(attn)
            _diverges(name, _round_tokens(name, out), solos)
            stats = _http(base, "GET", "/serve/lm")[1]
            rates[name] = {"wallSeconds": wall, **_round_rates(out, walls),
                           **{_CALL_KEYS[k]: _p50(v)
                              for k, v in calls.items()}}
            _http(base, "DELETE", "/serve/lm")
            held = _prefix_held(session)
            free = session.pool.free_count()
            if free != resp["kv"]["pagesTotal"] - held:
                raise AssertionError(f"{name}: {free} pages free after "
                                     f"delete, the prefix cache holds "
                                     f"{held} of {resp['kv']['pagesTotal']}")
        n_req = len(prompts) + len(first_use)
        disagg = stats["disagg"]
        per_request = LM_CONFIG["n_layers"] + DRAFT_CONFIG["n_layers"]
        want = dict.fromkeys(COUNTERS, 0)
        want["flash_fwd_tf32x3"] = per_request * len(prompts)
        if disagg["mode"] != "colocated" or \
                disagg["handoffsTotal"] != n_req or \
                disagg["handoffQueue"] != 0 or \
                set(stats["roles"]) != {"prefill", "decode", "draft"}:
            raise AssertionError(f"disagg stats: {disagg}, roles "
                                 f"{sorted(stats['roles'])}")
        if launches != want:
            raise AssertionError(f"disagg + spec launched {launches}, want "
                                 f"{want} ({LM_CONFIG['n_layers']} a target "
                                 f"prefill, {DRAFT_CONFIG['n_layers']} a "
                                 f"draft prefill, none in verify or "
                                 f"propose)")
        report["b"] = {
            "launches": launches, "tokensEqualSolo": True,
            "disagg": disagg, "spec": stats["spec"],
            "draftMsPerRound": stats["roles"]["draft"],
            "fullAcceptanceBound": spec_bound, **rates}

        # (c) the handoff fault, transient then latched
        report["c"] = {}
        for spec, sends in (("kv_page_handoff:1", 1),
                            ("kv_page_handoff:100", 3)):
            ctx.config.fault_inject = spec
            faults.reset()
            try:
                resp = _create(base, "lm", dict(paged, disagg=True))
                session = ctx.serving._sessions["lm"]
                total = resp["kv"]["pagesTotal"]
                for _ in range(sends):
                    status, body = _http(base, "POST", "/serve/lm/predict",
                                         {"prompt": prompts[0],
                                          "maxNewTokens": NEW_TOKENS})
                    if status != 429 or session.pool.free_count() != total:
                        raise AssertionError(
                            f"{spec}: {status} {body}, "
                            f"{session.pool.free_count()} of {total} free")
                if sends == 3:
                    deadline = time.monotonic() + 30
                    while session.disagg_mode != "fused-degraded":
                        if time.monotonic() > deadline:
                            raise AssertionError("the latched handoff "
                                                 "fault never collapsed")
                        time.sleep(0.01)
                out, _, _ = _predict_round(base, "lm", prompts[:2])
                _diverges(spec, _round_tokens(spec, out), solos[:2])
                stats = _http(base, "GET", "/serve/lm")[1]
                _http(base, "DELETE", "/serve/lm")
                if session.pool.free_count() != \
                        total - _prefix_held(session):
                    raise AssertionError(f"{spec}: the pool leaked")
                want_mode = "fused-degraded" if sends == 3 else "colocated"
                if stats["disagg"]["mode"] != want_mode:
                    raise AssertionError(f"{spec}: {stats['disagg']}")
                report["c"][spec] = {"rejected": sends,
                                     "disagg": stats["disagg"],
                                     "poolLeakFree": True,
                                     "tokensEqualSolo": True}
            finally:
                ctx.config.fault_inject = ""
                faults.reset()

        # (d) decode cadence under a burst, fused then disaggregated
        # two lengths: the round timer tells the streams apart by them
        streams = [[int(t) for t in x[i, :CADENCE_PROMPT - PAGE_LEN * j]]
                   for j, i in enumerate(measured[:2])]
        burst = [[int(t) for t in x[i, 13:13 + BURST_PROMPT]]
                 for i in warm[:2]]
        want_c = [solo(p, CADENCE_NEW) for p in streams] + \
            [solo(p, 1) for p in burst]
        report["d"] = [_cadence(base, ctx, dict(paged, **extra),
                                streams, burst, want_c)
                       for extra in ({}, {"disagg": True})]

        # (e) int8 KV pages with the self-draft
        _create(base, "lm", dict(paged, kvDtype="int8", draft="lm",
                                 specK=SPEC_K))
        out, walls, _ = _predict_round(base, "lm", prompts)
        tokens = _round_tokens("int8 spec", out)
        stats = _http(base, "GET", "/serve/lm")[1]
        report["e"] = {"agreement": _agreement(tokens, solos),
                       "spec": stats["spec"], "kv": stats["kv"]["dtype"],
                       "drift": stats.get("drift"),
                       **_round_rates(out, walls)}
        _http(base, "DELETE", "/serve/lm")

        # (f) the classifier, bucketed
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
        ctx.artifacts.save(yard["clf"], "clf", "train/tensorflow")
        clf_x = yard["clfRows"]
        _create(base, "clf", {"type": "predict"})
        sent = []
        _reset_launches(attn)
        offset = 0
        for n, bucket in BUCKET_BURSTS:
            rows = clf_x[offset:offset + n]
            offset += n
            status, body = _http(base, "POST", "/serve/clf/predict",
                                 {"x": rows.tolist()})
            if status != 200 or body["bucket"] != bucket:
                raise AssertionError(f"bucketed {n} rows: {status} "
                                     f"{body.get('bucket')}")
            sent.append((rows, body))
        out = [None] * len(BUCKET_CLIENTS)
        chunks = []
        for n in BUCKET_CLIENTS:
            chunks.append(clf_x[offset:offset + n])
            offset += n

        def client(i):
            out[i] = _http(base, "POST", "/serve/clf/predict",
                           {"x": chunks[i].tolist()})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(chunks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for rows, result in zip(chunks, out):
            if result is None or result[0] != 200:
                raise AssertionError(f"concurrent bucketed: {result}")
            sent.append((rows, result[1]))
        stats = _http(base, "GET", "/serve/clf")[1]
        clf_launches = _launches(attn)
        want = dict.fromkeys(COUNTERS, 0)
        want["flash_fwd_sm90"] = CLF_CONFIG["n_layers"] * \
            stats["predictsTotal"]
        if clf_launches != want:
            raise AssertionError(f"bucketed predict launched {clf_launches}"
                                 f", want {want}")
        _http(base, "DELETE", "/serve/clf")
        served = ctx.artifacts.load("clf")
    finally:
        server.stop()
        ctx.close()
    err, err_alone = 0.0, 0.0
    for rows, body in sent:
        n, bucket = len(rows), body["bucket"]
        got = np.asarray(body["predictions"], np.float32)
        if got.shape != (n, CLF_CONFIG["n_classes"]):
            raise AssertionError(f"bucketed answer shape {got.shape}")
        padded = np.concatenate([rows] + [rows[:1]] * (bucket - n))
        direct = served.predict(padded, batch_size=bucket)[:n]
        err = max(err, float(np.abs(got - direct).max()))
        err_alone = max(err_alone, float(np.abs(
            got - served.predict(rows, batch_size=n)).max()))
    if not err <= 1e-5:
        raise AssertionError(f"bucketed rows differ from a direct predict "
                             f"by {err}")
    report["f"] = {"buckets": [b["bucket"] for _, b in sent],
                   "maxAbsErrVsDirect": err,
                   "maxAbsErrVsUnpaddedPredict": err_alone,
                   "launches": clf_launches, "stats": {
                       k: stats[k] for k in ("predictsTotal", "rowsTotal",
                                             "batchFill", "perf")}}
    report["seconds"] = time.monotonic() - t0
    log.append("servingPlane " + json.dumps(report))
    return {"servingPlaneDraftFit": fit_launches,
            "servingPlaneDisaggSpec": report["b"]["launches"],
            "servingPlanePredict": clf_launches}


# ----------------------------------------------------------------------
# the keras path: NeuralModel (the tutorial's CNN and LSTM, ResNet-50)
# and the sweeps
# ----------------------------------------------------------------------
# docs/TUTORIAL.md workflow 2 (MNIST CNN) and workflow 3 (IMDb LSTM)
TUTORIAL_CNN = [
    {"kind": "reshape", "shape": [28, 28, 1]},
    {"kind": "conv2d", "filters": 32, "kernel": [3, 3],
     "activation": "relu"},
    {"kind": "maxpool2d"},
    {"kind": "flatten"},
    {"kind": "dense", "units": 128, "activation": "relu"},
    {"kind": "dense", "units": 10, "activation": "softmax"}]
TUTORIAL_LSTM = [{"kind": "embedding", "vocab": 20000, "dim": 128},
                 {"kind": "lstm", "units": 128},
                 {"kind": "dense", "units": 2, "activation": "softmax"}]
# MNIST's and IMDb's published shapes; data from seeds
MNIST_ROWS, MNIST_BATCH, MNIST_EPOCHS = 60000, 256, 2
IMDB_ROWS, IMDB_SEQ, IMDB_VOCAB, IMDB_BATCH = 25000, 200, 20000, 128
# the REST workflow's rows (two CSVs), its fit and the sweep over it
REST_ROWS, REST_EPOCHS = 1024, 2
SWEEP_GRID = {"learning_rate": [1e-3, 3e-4], "batch_size": [128, 256]}
CLF_SWEEP_GRID = {"learning_rate": [3e-4, 1e-3, 3e-3]}
# ResNet-50 (1000 classes, 224x224x3): 2 epochs of 4 steps at batch 64
RESNET_BATCH, RESNET_STEPS = 64, 8


def _mnist_like(np, n: int, seed: int):
    """``n`` rows of 784 pixels and labels: one of 10 fixed class
    templates (seed 1234) mixed with noise, quantized to k/256 (exact in
    a CSV of 8 decimals)."""
    templates = np.random.default_rng(1234).random((10, 784))
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = 0.6 * templates[y] + 0.4 * rng.random((n, 784))
    return (np.floor(x * 256) / 256).astype(np.float32), y


def _imdb_like(np, n: int, seed: int):
    """``n`` rows of 200 token ids in [1, 20000) and labels: whether an
    id below 1000 is among the last 10 (a task the LSTM's last state
    sees)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, IMDB_VOCAB, size=(n, IMDB_SEQ)).astype(np.int32)
    y = (x[:, -10:] < 1000).any(axis=1).astype(np.int32)
    return x, y


def _rel_l2(torch, got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _f32_step_vs_cpu(torch, body, x, y) -> dict:
    """One float32 micro-step of ``body`` from its seed-0 init on the card
    and on the CPU: the loss and each gradient's relative L2. (An init's
    loss and gradients are O(1); a fitted model's nearly cancel.)"""
    import numpy as np

    from learningorchestra_tpu_torch.models.neural import NeuralModel
    from learningorchestra_tpu_torch.runtime.data import MASK_KEY

    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    out, params = {}, None
    try:
        for device in ("cuda", "cpu"):
            model = NeuralModel(body, device=device)
            if params is None:
                model._build_params(model._coerce_x(x))
                params = {k: v.detach().cpu()
                          for k, v in model.params.items()}
            else:
                model.set_params(params, input_shape=x.shape[1:])
            eng = model._get_engine()
            batch = eng._to_device(
                {"x": model._coerce_x(x), "y": y.astype(np.int64),
                 MASK_KEY: np.ones(len(x), np.float32)}, model.device)
            grads, _, metrics = eng._micro_step(model.params,
                                                model.model_state, batch, 0)
            s, c = metrics["loss"]
            out[device] = (float(s) / float(c), grads)
    finally:
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    rel = {k: _rel_l2(torch, g, out["cpu"][1][k])
           for k, g in out["cuda"][1].items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    if not (rel[worst] <= 1e-4 and loss_rel <= 1e-4):
        raise AssertionError(f"float32 step on the card vs the CPU: loss "
                             f"{loss_rel}, gradient of {worst} {rel[worst]}")
    return {"lossRel": loss_rel, "gradRelL2Max": rel[worst], "worst": worst}


def _profile_fit(torch, model, x, y, batch: int, steps: int = 3) -> dict:
    """A profiler window of ``steps`` optimizer steps of ``model``'s fit
    engine (after one warm step): wall, device busy time, idle share and
    the top kernels. Params and batch statistics are restored after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = model._get_engine()
    live = {**model.params, **model.model_state}
    saved = {k: t.detach().clone() for k, t in live.items()}
    tstate = eng.init_state(model.params, model.model_state)
    batches = [eng._to_device(b, model.device) for b in model._batcher(
        x[:(steps + 1) * batch], y[:(steps + 1) * batch], batch).epoch(0)]
    eng._train_step_body(tstate, batches[0], 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.monotonic()
        for b in batches[1:]:
            eng._train_step_body(tstate, b, 0)
        torch.cuda.synchronize()
        window_ms = (time.monotonic() - w0) * 1e3
    with torch.no_grad():
        for k, t in live.items():
            t.copy_(saved[k])
    del saved, tstate, batches
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [[e.key[:80], e.self_device_time_total / 1e3 / steps,
            e.count / steps]
           for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                           reverse=True)[:8]]
    names = sorted({e.key[:60] for e in kernels})
    del prof, kernels
    gc.collect()
    return {"steps": steps, "windowMs": window_ms, "deviceBusyMs": busy_ms,
            "idleShare": 1.0 - busy_ms / window_ms,
            "stepMs": window_ms / steps, "topKernelsMsPerStep": top,
            "kernelNames": names}


def _write_csv(np, path, header, x, fmt) -> None:
    np.savetxt(path, x, fmt=fmt, delimiter=",", header=",".join(header),
               comments="")


def neural_phase(torch, log, home, yard):
    """The keras path on the card (the ``neural`` line): (a) the
    tutorial's CNN fitted directly on 60000 MNIST-shaped rows (batch 256,
    2 epochs, bf16): the loss falls, accuracy well above chance, step
    time, samples/s and the idle share of a profiled window, and one
    float32 step on the card within 1e-4 of the CPU's; (b) workflow 2
    over HTTP: two CSVs of 1024 rows through ``POST /dataset/csv``,
    ``/model``, ``/train`` with ``"checkpoint": true`` (epoch losses equal
    to a direct fit's on the same rows), ``/evaluate``, ``/predict``
    (rows sum to 1) and a PATCH resume that trains epoch 2 as the
    uninterrupted fit does; (c) workflow 3's LSTM fitted directly on
    25000 rows of 200 ids (batch 128, 1 epoch, bf16): the loss falls, the
    RNN route and its kernels, and float32 steps of ``gru`` and
    ``bidirectional_lstm`` bodies against the CPU; (d) ResNet-50 (1000
    classes, 224x224x3) in bf16, batch 64, 8 steps: finite loss,
    batch statistics that move, ``predict`` rows that sum to 1, step
    time, images/s and peak memory; (e) the tune route: a GridSearch over
    (b)'s CNN (4 points and a refit, per-trial peak memory) and a
    RandomSearch of 2 points over the classifier phase's TextClassifier
    (flash, bf16) on 1024 rows of 512 tokens, whose sm90 launches must be
    exactly 4 layers x (optimizer steps of the trials and the refit),
    plus one forward a layer for each evaluate batch. Returns each
    path's kernel launches."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import sequential_module as seq
    from learningorchestra_tpu_torch.models import sweep as sweep_lib
    from learningorchestra_tpu_torch.models.neural import NeuralModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    phase_t0 = time.monotonic()
    paths, out = {}, {}
    zero = dict.fromkeys(COUNTERS, 0)

    # (a) the tutorial CNN, direct
    x, y = _mnist_like(np, MNIST_ROWS, seed=0)
    cnn = NeuralModel(TUTORIAL_CNN, device="cuda")
    _reset_launches(attn)
    t0 = time.monotonic()
    hist = cnn.fit(x, y, batch_size=MNIST_BATCH,
                   epochs=MNIST_EPOCHS).history
    fit_s = time.monotonic() - t0
    paths["neuralCnn"] = _launches(attn)
    evaluated = cnn.evaluate(x[:10000], y[:10000], batch_size=1024)
    if not (hist["loss"][1] < hist["loss"][0] and
            evaluated["accuracy"] > 0.5 and paths["neuralCnn"] == zero):
        raise AssertionError(f"the CNN fit: {hist}, evaluate {evaluated}, "
                             f"launches {paths['neuralCnn']}")
    steps = -(-MNIST_ROWS // MNIST_BATCH)
    out["cnn"] = {
        "rows": MNIST_ROWS, "batch": MNIST_BATCH, "epochs": MNIST_EPOCHS,
        "params": cnn.num_params(), "history": hist, "fitSeconds": fit_s,
        "evaluate": evaluated,
        "stepMsEpoch2": hist["epochSeconds"][-1] / steps * 1e3,
        "samplesPerSecEpoch2": hist["samplesPerSecond"][-1],
        "profile": _profile_fit(torch, cnn, x, y, MNIST_BATCH),
        "f32StepVsCpu": _f32_step_vs_cpu(torch, TUTORIAL_CNN,
                                         x[:MNIST_BATCH], y[:MNIST_BATCH])}
    del out["cnn"]["profile"]["kernelNames"]
    del cnn, x, y
    gc.collect()

    # (b) workflow 2 over HTTP, and (e) the tune route on its server
    rx, ry = _mnist_like(np, REST_ROWS, seed=1)
    pix_csv = os.path.join(home, "pixels.csv")
    lab_csv = os.path.join(home, "labels.csv")
    _write_csv(np, pix_csv, [f"p{i}" for i in range(784)], rx, "%.8f")
    _write_csv(np, lab_csv, ["label"], ry[:, None], "%d")
    direct = NeuralModel(TUTORIAL_CNN, device="cuda")
    want = direct.fit(rx, ry, batch_size=MNIST_BATCH,
                      epochs=REST_EPOCHS).history["loss"]
    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    trial_mem = []
    real_trial = sweep_lib.GridSearch._run_trial

    def measured_trial(self, combo, *args, **kwargs):
        # what is live as a trial starts (the sweep collects each trial's
        # model after it), and the trial's own peak above that
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        result = real_trial(self, combo, *args, **kwargs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        trial_mem.append({"params": combo, "beforeBytes": before,
                          "peakBytes": peak, "trialPeakBytes": peak - before})
        return result

    def post(path, body, status=201):
        got, answer = _http(base, "POST", path, body)
        if got != status:
            raise AssertionError(f"POST {path}: {got} {answer}")
        return answer

    def run(verb, name, parent, method, params):
        post(f"/{verb}/tensorflow", {"name": name, "modelName": parent,
                                     "method": method,
                                     "methodParameters": params})
        return _poll(base, f"/{verb}/tensorflow/{name}")

    def docs(verb, name):
        return _http(base, "GET", f"/{verb}/tensorflow/{name}")[1]["result"]

    def model(name, cls, params):
        post("/model/tensorflow", {"modelName": name, "modulePath":
                                   "learningorchestra_tpu.models",
                                   "class": cls, "classParameters": params})
        _poll(base, f"/model/tensorflow/{name}")

    sweep_lib.GridSearch._run_trial = measured_trial
    try:
        t0 = time.monotonic()
        for name, path in (("pixels", pix_csv), ("labels", lab_csv)):
            post("/dataset/csv", {"datasetName": name, "datasetURI": path})
            _poll(base, f"/dataset/csv/{name}")
        ingest_s = time.monotonic() - t0
        model("cnn", "NeuralModel", {"layer_configs": TUTORIAL_CNN})
        fit = {"x": "$pixels", "y": "$labels", "epochs": REST_EPOCHS,
               "batch_size": MNIST_BATCH, "checkpoint": True}
        _reset_launches(attn)
        t0 = time.monotonic()
        meta = run("train", "cnn_t", "cnn", "fit", fit)
        train_s = time.monotonic() - t0
        paths["neuralRest"] = _launches(attn)
        got = [d["epochRecord"]["loss"] for d in docs("train", "cnn_t")
               if "epochRecord" in d]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if len(got) != REST_EPOCHS or not rel <= 1e-5 or \
                len(meta.get("checkpointCommits", [])) != REST_EPOCHS:
            raise AssertionError(f"REST fit losses {got} against the "
                                 f"direct fit's {want}; metadata {meta}")
        run("evaluate", "cnn_e", "cnn_t", "evaluate",
            {"x": "$pixels", "y": "$labels", "batch_size": MNIST_BATCH})
        ev = next(d["result"] for d in docs("evaluate", "cnn_e")
                  if "result" in d)
        run("predict", "cnn_p", "cnn_t", "predict",
            {"x": "$pixels", "batch_size": MNIST_BATCH})
        probs = np.asarray(ctx.artifacts.load("cnn_p"))
        row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
        if probs.shape != (REST_ROWS, 10) or not row_err <= 1e-5:
            raise AssertionError(f"predict: shape {probs.shape}, max |sum "
                                 f"- 1| {row_err}")
        # resume: 1 epoch, then PATCHed to 2 from its checkpoint
        run("train", "cnn_r", "cnn", "fit", dict(fit, epochs=1))
        status, answer = _http(base, "PATCH", "/train/tensorflow/cnn_r",
                               {"methodParameters": fit})
        if status != 200:
            raise AssertionError(f"PATCH cnn_r: {status} {answer}")
        meta_r = _poll(base, "/train/tensorflow/cnn_r")
        resumed = [d["epochRecord"]["loss"] for d in docs("train", "cnn_r")
                   if "epochRecord" in d]
        resume_rel = abs(resumed[-1] - got[-1]) / abs(got[-1])
        if not resume_rel <= 1e-5 or not meta_r.get("checkpointRestores"):
            raise AssertionError(f"the resumed epoch 2 lost {resumed[-1]}, "
                                 f"the uninterrupted {got[-1]}; {meta_r}")
        out["rest"] = {
            "rows": REST_ROWS, "ingestSeconds": ingest_s,
            "trainJobSeconds": train_s, "losses": got, "directLosses": want,
            "bitEqualToDirect": got == want, "maxRelToDirect": rel,
            "checkpointCommits": len(meta["checkpointCommits"]),
            "evaluate": ev, "predictRowSumMaxErr": row_err,
            "resumedEpoch2Loss": resumed[-1],
            "resumedBitEqual": resumed[-1] == got[-1],
            "restoredStep": meta_r["checkpointRestores"][-1]["step"]}

        # (e) the GridSearch over $cnn through /model and /tune, every
        # point a trial of its own (the fusion phase fuses this sweep)
        model("sweep", "GridSearch", {"estimator": "$cnn",
                                      "param_grid": SWEEP_GRID})
        _reset_launches(attn)
        t0 = time.monotonic()
        os.environ["LO_SWEEP_FUSION"] = "0"
        try:
            meta_s = run("tune", "sweep_t", "sweep", "fit",
                         {"x": "$pixels", "y": "$labels", "epochs": 1})
        finally:
            os.environ["LO_SWEEP_FUSION"] = "1"
        sweep_s = time.monotonic() - t0
        paths["neuralGridSearch"] = _launches(attn)
        swept = ctx.artifacts.load("sweep_t")
        points = len(swept.cv_results_["params"])
        if points != 4 or swept.best_estimator_ is None or \
                swept.best_params_ not in swept.cv_results_["params"] or \
                meta_s.get("sweepFusion", {}).get("fusedTrials") != 0 or \
                paths["neuralGridSearch"] != zero:
            raise AssertionError(f"the grid sweep: {swept.cv_results_}, "
                                 f"metadata {meta_s}")
        grid_mem = list(trial_mem)
        befores = [m["beforeBytes"] for m in grid_mem]
        leaked = max(befores) - min(befores)
        by_batch = {}
        for m in grid_mem:
            by_batch.setdefault(m["params"]["batch_size"], []).append(
                m["trialPeakBytes"])
        spread = max(max(v) / min(v) - 1 for v in by_batch.values())
        if leaked > 1 << 20 or spread > 0.1:
            raise AssertionError(f"trial memory not flat: {grid_mem}")

        # (e) a RandomSearch over the tutorial TextClassifier (flash)
        cx, cy = _marker_rows(np, CLF_ROWS, CLF_SEQ,
                              CLF_CONFIG["vocab_size"], seed=0)
        tok_csv = os.path.join(home, "clf_rows.csv")
        _write_csv(np, tok_csv, [f"t{i}" for i in range(CLF_SEQ)], cx, "%d")
        _write_csv(np, os.path.join(home, "clf_labels.csv"), ["label"],
                   cy[:, None], "%d")
        for name in ("clf_rows", "clf_labels"):
            post("/dataset/csv", {"datasetName": name, "datasetURI":
                                  os.path.join(home, f"{name}.csv")})
            _poll(base, f"/dataset/csv/{name}")
        model("clf", "TextClassifier", dict(CLF_CONFIG, attention="flash"))
        model("rsweep", "RandomSearch", {"estimator": "$clf", "param_grid":
                                         CLF_SWEEP_GRID, "n_iter": 2})
        _reset_launches(attn)
        t0 = time.monotonic()
        meta_rs = run("tune", "rsweep_t", "rsweep", "fit",
                      {"x": "$clf_rows", "y": "$clf_labels", "epochs": 1,
                       "batch_size": CLF_BATCH})
        rsweep_s = time.monotonic() - t0
        paths["neuralRandomSearch"] = _launches(attn)
        rswept = ctx.artifacts.load("rsweep_t")
        n_val = int(CLF_ROWS * 0.2)
        trial_steps = -(-(CLF_ROWS - n_val) // CLF_BATCH)
        eval_batches = -(-n_val // CLF_BATCH)
        refit_steps = -(-CLF_ROWS // CLF_BATCH)
        layers = CLF_CONFIG["n_layers"]
        optimizer_steps = 2 * trial_steps + refit_steps
        want_rs = dict(zero)
        want_rs.update(dict.fromkeys(
            ("flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
            layers * optimizer_steps))
        want_rs["flash_fwd_sm90"] = layers * (optimizer_steps +
                                              2 * eval_batches)
        if paths["neuralRandomSearch"] != want_rs or \
                len(rswept.cv_results_["params"]) != 2:
            raise AssertionError(f"the classifier sweep launched "
                                 f"{paths['neuralRandomSearch']}, want "
                                 f"{want_rs}; {rswept.cv_results_}")
        out["tune"] = {
            "gridSearch": {
                "grid": SWEEP_GRID, "epochs": 1, "seconds": sweep_s,
                "cvResults": swept.cv_results_,
                "bestParams": swept.best_params_,
                "bestScore": swept.best_score_,
                "sweepFusion": meta_s["sweepFusion"],
                "trialMemory": grid_mem, "leakedBytes": leaked,
                "peakSpreadSameBatch": spread},
            "randomSearch": {
                "grid": CLF_SWEEP_GRID, "nIter": 2, "seconds": rsweep_s,
                "cvResults": rswept.cv_results_,
                "bestParams": rswept.best_params_,
                "sweepFusion": meta_rs["sweepFusion"],
                "launches": paths["neuralRandomSearch"],
                "trialMemory": trial_mem[len(grid_mem):],
                "launchFormula": f"bwd = {layers} layers x (2 trials x "
                                 f"{trial_steps} + refit {refit_steps}) "
                                 f"steps = {layers * optimizer_steps}; "
                                 f"fwd = that + {layers} x 2 trials x "
                                 f"{eval_batches} evaluate batches = "
                                 f"{want_rs['flash_fwd_sm90']}"}}
    finally:
        sweep_lib.GridSearch._run_trial = real_trial
        server.stop()
        ctx.close()
    del direct, swept, rswept
    gc.collect()

    # (c) workflow 3's LSTM, direct
    ix, iy = _imdb_like(np, IMDB_ROWS, seed=0)
    lstm = NeuralModel(TUTORIAL_LSTM, device="cuda")
    lstm._build_params(lstm._coerce_x(ix[:1]))
    last = (ix[-1024:], iy[-1024:])
    before = lstm.evaluate(*last, batch_size=1024)["loss"]
    _reset_launches(attn)
    hist = lstm.fit(ix, iy, batch_size=IMDB_BATCH, epochs=1).history
    paths["neuralLstm"] = _launches(attn)
    after = lstm.evaluate(*last, batch_size=1024)["loss"]
    if not (np.isfinite(hist["loss"][0]) and after < before and
            paths["neuralLstm"] == zero):
        raise AssertionError(f"the LSTM fit: the last rows' loss {before} "
                             f"-> {after}, {hist}")
    prof = _profile_fit(torch, lstm, ix, iy, IMDB_BATCH)
    rnn_kernels = [k for k in prof.pop("kernelNames")
                   if any(w in k for w in ("RNN", "LSTM", "GRU", "rnn"))]
    small = (ix[:32], iy[:32])
    f32 = {}
    for name, body in (("gru", [TUTORIAL_LSTM[0],
                                {"kind": "gru", "units": 128},
                                TUTORIAL_LSTM[2]]),
                       ("bidirectional_lstm", [
                           TUTORIAL_LSTM[0],
                           {"kind": "bidirectional_lstm", "units": 128},
                           TUTORIAL_LSTM[2]])):
        f32[name] = _f32_step_vs_cpu(torch, body, *small)
    out["lstm"] = {
        "rows": IMDB_ROWS, "seq": IMDB_SEQ, "batch": IMDB_BATCH,
        "route": seq.rnn_route("lstm"), "routeKernels": rnn_kernels,
        "history": hist, "lastRowsLossBeforeAfter": [before, after],
        "samplesPerSec": hist["samplesPerSecond"][0],
        "stepMs": hist["epochSeconds"][0] / -(-IMDB_ROWS // IMDB_BATCH)
        * 1e3, "profile": prof, "f32StepVsCpu": f32}
    if not rnn_kernels:
        raise AssertionError("the LSTM's profile shows no RNN kernel")
    del lstm, ix, iy
    gc.collect()

    # (d) ResNet-50
    rng = np.random.default_rng(0)
    images = RESNET_BATCH * RESNET_STEPS // 2
    rx = rng.standard_normal((images, 224, 224, 3), dtype=np.float32)
    ry = rng.integers(0, 1000, images).astype(np.int32)
    net = NeuralModel([{"kind": "resnet50"},
                       {"kind": "activation", "fn": "softmax"}],
                      device="cuda")
    net._build_params(rx[:1])
    stats0 = {k: v.clone() for k, v in net.model_state.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(attn)
    hist = net.fit(rx, ry, batch_size=RESNET_BATCH, epochs=2,
                   shuffle=False).history
    paths["neuralResnet"] = _launches(attn)
    peak = torch.cuda.max_memory_allocated()
    moved = sum(not torch.equal(v, stats0[k])
                for k, v in net.model_state.items())
    probs = net.predict(rx[:RESNET_BATCH], batch_size=RESNET_BATCH)
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    if not (all(np.isfinite(hist["loss"])) and moved == len(stats0) and
            probs.shape == (RESNET_BATCH, 1000) and row_err <= 1e-5 and
            paths["neuralResnet"] == zero):
        raise AssertionError(f"ResNet-50: {hist}, {moved} of {len(stats0)} "
                             f"statistics moved, predict {probs.shape} "
                             f"{row_err}")
    step_ms = hist["epochSeconds"][-1] / (RESNET_STEPS // 2) * 1e3
    out["resnet50"] = {
        "batch": RESNET_BATCH, "steps": RESNET_STEPS, "params":
        net.num_params(), "history": hist, "stepMsEpoch2": step_ms,
        "imagesPerSecEpoch2": RESNET_BATCH / step_ms * 1e3,
        "peakBytes": peak, "statsMoved": moved,
        "predictRowSumMaxErr": row_err}
    del net, rx
    gc.collect()
    out["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("neural " + json.dumps(out))
    return paths


# ----------------------------------------------------------------------
# the reference's tensorflow.keras contract: the shim, '#tensorflow' in
# the DSL, real keras artifacts, BASELINE config 5 in the reference's form
# ----------------------------------------------------------------------
# the tutorial CNN's layers as the reference's '#' DSL writes them
# (keras's Conv2D pads "valid": 13x13x32 = 5408 features into dense 128)
KERAS_CNN_LAYERS = [
    "#tensorflow.keras.layers.Reshape((28, 28, 1))",
    "#tensorflow.keras.layers.Conv2D(32, (3, 3), activation='relu')",
    "#tensorflow.keras.layers.MaxPooling2D()",
    "#tensorflow.keras.layers.Flatten()",
    "#tensorflow.keras.layers.Dense(128, activation='relu')",
    "#tensorflow.keras.layers.Dense(10, activation='softmax')"]
KERAS_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "fixtures", "keras")
# the float32 bound of an imported model's predictions against
# TensorFlow's own (tests/fixtures/keras/*/want.npy)
KERAS_IMPORT_ATOL = 1e-4
# BASELINE config 5: ResNet-50 fitted for 2 steps of 32 and exported,
# then a GridSearch of two learning rates over 64 images (batch 32)
RESNET_PRE_BATCH, RESNET_TUNE_IMAGES = 32, 64
KERAS_LR_GRID = [1e-3, 1e-4]


def _fixture(name: str):
    """(meta, x, want) of one committed keras fixture."""
    import numpy as np

    folder = os.path.join(KERAS_FIXTURES, name)
    with open(os.path.join(folder, "meta.json")) as f:
        meta = json.load(f)
    return (meta, np.load(os.path.join(folder, meta["x"])),
            np.load(os.path.join(folder, meta["want"])))


def _importable(module: str):
    """The module's version where it imports, else the error's text."""
    import importlib

    try:
        mod = importlib.import_module(module)
    except ImportError as exc:
        return False, f"{type(exc).__name__}: {exc}"
    return True, getattr(mod, "__version__", "?")


def keras_phase(torch, log, home, yard):
    """The reference's tensorflow.keras contract on the card (the
    ``keras`` line): (a) the tutorial CNN at full width over HTTP as the
    reference writes it: ``POST /model/tensorflow`` with
    ``tensorflow.keras.models`` / ``Sequential`` and six
    ``#tensorflow.keras.layers`` strings, ``compile`` with
    ``#tensorflow.keras.optimizers.Adam(1e-3)``, ``fit`` on 60000
    MNIST-shaped rows (2 epochs, batch 256, bf16) and ``evaluate``: the
    loss falls, accuracy above 0.5, the epoch losses within 1e-5 of a
    direct ``NeuralModel`` fit from the same init and batches (bit
    equality recorded) and the ``#`` passes' child seconds; (b) each
    committed SavedModel fixture through ``load_model`` on ``/model`` and
    ``/predict`` in float32, within 1e-4 of TensorFlow's predictions;
    (c) whether h5py and keras import here, and then the ``.keras`` and
    legacy ``.h5`` fixtures within the same bound and a ``save_keras`` ->
    ``from_keras`` round trip within 1e-6, or else each call's
    ``ImportError`` naming the module; (d) BASELINE config 5: a
    ResNet-50 (1000 classes, 224x224x3) fitted 2 steps and exported with
    ``save_weights``, created through ``tensorflow.keras.applications`` /
    ``ResNet50`` with that file (predictions equal to the exporter's
    within 1e-6) and swept by a GridSearch of two learning rates on
    ``/tune`` (card memory at each trial's start within 1 MiB); (e) no
    flash kernel launches in the phase."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import sweep as sweep_lib
    from learningorchestra_tpu_torch.models.neural import NeuralModel
    from learningorchestra_tpu_torch.models.tf_compat.keras import (
        applications, layers as shim_layers, models as shim_models)
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services import sandbox
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    phase_t0 = time.monotonic()
    out = {}
    zero = dict.fromkeys(COUNTERS, 0)
    _reset_launches(attn)
    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    hash_passes = []
    real_eval = sandbox.eval_hash_expressions

    def timed_eval(exprs, *args, **kwargs):
        t0 = time.monotonic()
        values = real_eval(exprs, *args, **kwargs)
        if exprs:
            hash_passes.append({"expressions": len(exprs),
                                "seconds": time.monotonic() - t0})
        return values

    def post(path, body, status=201):
        got, answer = _http(base, "POST", path, body)
        if got != status:
            raise AssertionError(f"POST {path}: {got} {answer}")
        return answer

    def run(verb, name, parent, method, params):
        post(f"/{verb}/tensorflow", {"name": name, "modelName": parent,
                                     "method": method,
                                     "methodParameters": params})
        return _poll(base, f"/{verb}/tensorflow/{name}")

    def model(name, module, cls, params):
        post("/model/tensorflow", {"modelName": name, "modulePath": module,
                                   "class": cls, "classParameters": params})
        return _poll(base, f"/model/tensorflow/{name}")

    def docs(verb, name):
        return _http(base, "GET", f"/{verb}/tensorflow/{name}")[1]["result"]

    sandbox.eval_hash_expressions = timed_eval
    try:
        # (a) the reference's lineage at the tutorial CNN's full width
        x, y = _mnist_like(np, MNIST_ROWS, seed=0)
        _save_arrays(ctx, "mnist", {"x": x, "y": y})
        t0 = time.monotonic()
        model("cnn", "tensorflow.keras.models", "Sequential",
              {"layers": KERAS_CNN_LAYERS})
        model_s = time.monotonic() - t0
        run("train", "cnn_c", "cnn", "compile", {
            "optimizer": "#tensorflow.keras.optimizers.Adam(1e-3)",
            "loss": "sparse_categorical_crossentropy",
            "metrics": ["accuracy"]})
        t0 = time.monotonic()
        run("train", "cnn_t", "cnn_c", "fit",
            {"x": "$mnist.x", "y": "$mnist.y", "epochs": MNIST_EPOCHS,
             "batch_size": MNIST_BATCH})
        fit_s = time.monotonic() - t0
        got = [d["epochRecord"]["loss"] for d in docs("train", "cnn_t")
               if "epochRecord" in d]
        run("evaluate", "cnn_e", "cnn_t", "evaluate",
            {"x": "$mnist.x", "y": "$mnist.y", "batch_size": 1024})
        evaluated = next(d["result"] for d in docs("evaluate", "cnn_e")
                         if "result" in d)
        stored = ctx.artifacts.load("cnn")
        configs = [shim_layers.Reshape((28, 28, 1)).config,
                   shim_layers.Conv2D(32, (3, 3), activation="relu").config,
                   shim_layers.MaxPooling2D().config,
                   shim_layers.Flatten().config,
                   shim_layers.Dense(128, activation="relu").config,
                   shim_layers.Dense(10, activation="softmax").config]
        direct = NeuralModel(configs, device="cuda")
        direct.compile({"kind": "adam", "learning_rate": 1e-3})
        want = direct.fit(x, y, batch_size=MNIST_BATCH,
                          epochs=MNIST_EPOCHS).history["loss"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if type(stored).__name__ != "Sequential" or \
                stored.layer_configs != configs or \
                len(got) != MNIST_EPOCHS or not got[-1] < got[0] or \
                not evaluated["accuracy"] > 0.5 or not rel <= 1e-5:
            raise AssertionError(
                f"the keras lineage: {type(stored).__name__} "
                f"{stored.layer_configs}, losses {got} against the direct "
                f"fit's {want}, evaluate {evaluated}")
        out["lineage"] = {
            "rows": MNIST_ROWS, "batch": MNIST_BATCH, "epochs": MNIST_EPOCHS,
            "params": direct.num_params(), "losses": got,
            "directLosses": want, "maxRelToDirect": rel,
            "bitEqualToDirect": got == want, "evaluate": evaluated,
            "modelJobSeconds": model_s, "fitJobSeconds": fit_s,
            "hashPasses": list(hash_passes)}
        del x, y, direct, stored
        gc.collect()

        # (b) SavedModel import on the card, float32
        os.environ["LO_COMPUTE_DTYPE"] = "float32"
        imports = {}
        for name in ("cnn", "rnn"):
            meta, fx, fwant = _fixture(name)
            path = os.path.join(KERAS_FIXTURES, name,
                                meta["formats"]["savedmodel"])
            t0 = time.monotonic()
            model(f"{name}_sm", "tensorflow.keras.models", "load_model",
                  {"path": path})
            load_s = time.monotonic() - t0
            run("predict", f"{name}_sm_p", f"{name}_sm", "predict",
                {"x": fx.tolist(), "batch_size": len(fx)})
            pred = np.asarray(ctx.artifacts.load(f"{name}_sm_p"))
            gap = float(np.abs(pred - fwant).max())
            if pred.shape != fwant.shape or not gap <= KERAS_IMPORT_ATOL:
                raise AssertionError(f"SavedModel {name}: shape "
                                     f"{pred.shape}, max gap {gap}")
            imports[f"{name}/savedmodel"] = {
                "params": meta["params"], "layers": meta["layers"],
                "maxAbsGap": gap, "loadJobSeconds": load_s}
        out["savedModel"] = imports

        # (c) .keras, legacy .h5 and save_keras
        have = {m: _importable(m) for m in ("h5py", "keras")}
        formats = {}
        for name, fmt in (("cnn_narrow", "keras"), ("cnn_narrow", "h5"),
                          ("rnn", "keras"), ("rnn", "h5")):
            meta, fx, fwant = _fixture(name)
            path = os.path.join(KERAS_FIXTURES, name, meta["formats"][fmt])
            try:
                loaded = shim_models.load_model(path, device="cuda")
            except ImportError as exc:
                if have["h5py"][0] or exc.name != "h5py":
                    raise
                formats[f"{name}/{fmt}"] = {"importError": str(exc)}
                continue
            gap = float(np.abs(loaded.predict(fx, batch_size=len(fx))
                               - fwant).max())
            if not gap <= KERAS_IMPORT_ATOL:
                raise AssertionError(f"{name} {fmt}: max gap {gap}")
            formats[f"{name}/{fmt}"] = {"maxAbsGap": gap}
        full = ctx.artifacts.load("cnn_sm")
        _, fx, _ = _fixture("cnn")
        exported = os.path.join(home, "cnn.keras")
        try:
            full.save_keras(exported)
            back = NeuralModel.from_keras(exported, device="cuda")
            gap = float(np.abs(back.predict(fx, batch_size=len(fx))
                               - full.predict(fx, batch_size=len(fx))).max())
            if not gap <= 1e-6:
                raise AssertionError(f"save_keras -> from_keras: {gap}")
            formats["saveKerasRoundTrip"] = {"maxAbsGap": gap}
        except ImportError as exc:
            if exc.name not in ("keras", "h5py") or have[exc.name][0]:
                raise
            formats["saveKerasRoundTrip"] = {"importError": str(exc)}
        out["kerasFormats"] = {"importable": {
            m: {"imports": ok, "detail": detail}
            for m, (ok, detail) in have.items()}, **formats}
        del full
        gc.collect()
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"

        # (d) BASELINE config 5: ResNet-50 exported, created by module
        # path with its weights, then swept on /tune
        rng = np.random.default_rng(5)
        rx = rng.standard_normal((RESNET_TUNE_IMAGES, 224, 224, 3),
                                 dtype=np.float32)
        ry = rng.integers(0, 1000, RESNET_TUNE_IMAGES).astype(np.int32)
        pre = applications.ResNet50(device="cuda")
        t0 = time.monotonic()
        pre_hist = pre.fit(rx[:2 * RESNET_PRE_BATCH],
                           ry[:2 * RESNET_PRE_BATCH],
                           batch_size=RESNET_PRE_BATCH, epochs=1,
                           shuffle=False).history
        pre_s = time.monotonic() - t0
        npz = os.path.join(home, "resnet50_pretrained.npz")
        pre.save_weights(npz)
        model("rn", "tensorflow.keras.applications", "ResNet50",
              {"weights": npz, "input_shape": [224, 224, 3]})
        loaded = ctx.artifacts.load("rn")
        probe = rx[:8]
        rn_gap = float(np.abs(loaded.predict(probe, batch_size=8)
                              - pre.predict(probe, batch_size=8)).max())
        del loaded, pre
        gc.collect()
        if not rn_gap <= 1e-6:
            raise AssertionError(f"ResNet50(weights=npz) predicts {rn_gap} "
                                 f"off the exporter")
        _save_arrays(ctx, "rn_data", {"x": rx, "y": ry})
        model("rn_sweep", "learningorchestra_tpu.models", "GridSearch",
              {"estimator": "$rn", "param_grid": {
                  "learning_rate": KERAS_LR_GRID}})
        trial_mem = []
        real_trial = sweep_lib.GridSearch._run_trial

        def measured_trial(self, combo, *args, **kwargs):
            gc.collect()
            torch.cuda.synchronize()
            trial_mem.append({"params": combo,
                              "beforeBytes": torch.cuda.memory_allocated()})
            return real_trial(self, combo, *args, **kwargs)

        # every point a trial of its own (the fusion phase fuses it)
        sweep_lib.GridSearch._run_trial = measured_trial
        os.environ["LO_SWEEP_FUSION"] = "0"
        try:
            t0 = time.monotonic()
            meta_t = run("tune", "rn_tune", "rn_sweep", "fit",
                         {"x": "$rn_data.x", "y": "$rn_data.y",
                          "epochs": 1, "batch_size": RESNET_PRE_BATCH})
            tune_s = time.monotonic() - t0
        finally:
            sweep_lib.GridSearch._run_trial = real_trial
            os.environ["LO_SWEEP_FUSION"] = "1"
        swept = ctx.artifacts.load("rn_tune")
        befores = [m["beforeBytes"] for m in trial_mem]
        leaked = max(befores) - min(befores)
        if swept.best_params_ is None or \
                len(swept.cv_results_["params"]) != len(KERAS_LR_GRID) or \
                len(trial_mem) != len(KERAS_LR_GRID) or leaked > 1 << 20:
            raise AssertionError(f"the ResNet-50 sweep: {swept.cv_results_},"
                                 f" trial memory {trial_mem}")
        out["baseline5"] = {
            "classes": 1000, "input": [224, 224, 3],
            "pretrainSteps": 2, "pretrainBatch": RESNET_PRE_BATCH,
            "pretrainLosses": pre_hist["loss"], "pretrainSeconds": pre_s,
            "weightsBytes": os.path.getsize(npz),
            "loadedVsExporterMaxAbs": rn_gap, "grid": KERAS_LR_GRID,
            "images": RESNET_TUNE_IMAGES, "tuneJobSeconds": tune_s,
            "cvResults": swept.cv_results_,
            "bestParams": swept.best_params_,
            "sweepFusion": meta_t.get("sweepFusion"),
            "trialStartBytes": befores, "leakedBytes": leaked}
        del swept, rx
        gc.collect()
    finally:
        sandbox.eval_hash_expressions = real_eval
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
        server.stop()
        ctx.close()
    # (e) the phase launched no flash kernel
    launched = _launches(attn)
    if launched != zero:
        raise AssertionError(f"the keras phase launched {launched}")
    out["launches"] = launched
    out["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("keras " + json.dumps(out))
    return {"keras": launched}


# ----------------------------------------------------------------------
# sweep fusion: the keras path's sweeps as fused cohorts
# ----------------------------------------------------------------------
FUSION_LSTM_ROWS = 2048
FUSION_LSTM_GRID = {"learning_rate": [1e-3, 3e-3]}
# a cohort whose second config cannot keep up: early stop freezes it
EARLYSTOP_GRID = {"learning_rate": [3e-3, 1e-8]}
EARLYSTOP_EPOCHS, EARLYSTOP_BATCH = 4, 64
FUSION_TOL = 1e-4
# fused and unfused sweeps run in the keras path's bf16 (seconds, launches)
# and in float32 without TF32, also with cuDNN off (PyTorch's own
# convolutions): mode -> (compute dtype, cuDNN on)
FUSION_MODES = {"bfloat16": ("bfloat16", True), "float32": ("float32", True),
                "float32CudnnOff": ("float32", False)}
FUSION_KEYS = ("fusedTrials", "cohorts", "fallbackTrials", "earlyStopped")


def _device_launches(torch, fn) -> tuple:
    """``(fn(), kernels the card ran while it did)``, copies and fills
    left out, from a CUDA-only profiler window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset")))
    del prof
    return out, n


def _sweep_gaps(fused, unfused) -> dict:
    """Each point's largest metric gap between a fused and an unfused
    sweep of one grid, with the points and best params of both."""
    gaps = [max(abs(f[k] - u[k]) for k in u) if sorted(f) == sorted(u)
            else float("inf")
            for f, u in zip(fused.cv_results_["metrics"],
                            unfused.cv_results_["metrics"])]
    return {"points": fused.cv_results_["params"],
            "samePoints": fused.cv_results_["params"] ==
            unfused.cv_results_["params"],
            "maxGapPerPoint": gaps,
            "bestParams": [fused.best_params_, unfused.best_params_],
            "metricsFused": fused.cv_results_["metrics"],
            "metricsUnfused": unfused.cv_results_["metrics"]}


def _grad_gap(a, b, i=None) -> float:
    """Relative L2 of gradient dict ``a`` (config ``i`` of a stacked one)
    against ``b``, over every tensor."""
    norm2 = sum(float(g.double().norm()) ** 2 for g in b.values())
    return math.sqrt(sum(float(((a[k] if i is None else a[k][i]).double()
                                - g.double()).norm()) ** 2
                         for k, g in b.items()) / norm2)


def _fused_first_step(torch, body, x, y, lrs) -> dict:
    """One float32 step (TF32 off) of ``body`` from one init on one
    batch, through the unfused engine and through the fused engine over
    the learning rates ``lrs``, with cuDNN off (PyTorch's own
    convolutions): each config's train and inference loss, its whole
    gradient (relative L2 over every tensor) and each new batch
    statistic against the unfused step's. With cuDNN on, the fused and
    the unfused gradients' gap and the unfused gradient's own gap to the
    cuDNN-off one. A step's gradients do not depend on the learning
    rate, so every config must give them."""
    import numpy as np

    from learningorchestra_tpu_torch.models.neural import (
        _LOSSES, _METRICS, NeuralModel, build_optimizer_factory)
    from learningorchestra_tpu_torch.runtime import engine as engine_lib
    from learningorchestra_tpu_torch.runtime.data import MASK_KEY

    os.environ["LO_COMPUTE_DTYPE"] = "float32"
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = NeuralModel(body, device="cuda")
        model._build_params(model._coerce_x(x))
        eng = model._get_engine()
        batch = eng._to_device(
            {"x": model._coerce_x(x), "y": y.astype(np.int64),
             MASK_KEY: np.ones(len(x), np.float32)}, model.device)
        feng = engine_lib.FusedEngine(
            apply_fn=model._fused_apply_fn, loss_fn=_LOSSES[model.loss_name],
            optimizer_factory=build_optimizer_factory(model.optimizer_spec),
            hyper={"learning_rate": lrs},
            metrics={n: _METRICS[n] for n in model.metric_names},
            compute_dtype=torch.float32)
        state = feng.init_fused_state(model.params, model.model_state)
        runs = {}
        for cudnn in (False, True):
            torch.backends.cudnn.enabled = cudnn
            try:
                grads, stats, metrics = eng._micro_step(
                    model.params, model.model_state, batch, 0)
                fgrads, fstats, fmetrics = feng._fused_micro(
                    state.params, state.model_state, batch, 0)
                with torch.inference_mode():
                    loss = eng._loss(eng._cast(model.params), batch, False,
                                     None, model.model_state)[0]
                    floss = feng._vmapped(state.params, state.model_state,
                                          batch, False, None)[0]
            finally:
                torch.backends.cudnn.enabled = True
            runs[cudnn] = (grads, stats, metrics, fgrads, fstats, fmetrics,
                           loss, floss)
        grads, stats, metrics, fgrads, fstats, fmetrics, loss, floss = \
            runs[False]
        train = float(metrics["loss"][0] / metrics["loss"][1])
        out = {"trainLoss": train, "evalLoss": float(loss), "configs": [],
               "cudnn": {
                   "fusedVsUnfused": [_grad_gap(runs[True][3], runs[True][0],
                                                i) for i in range(len(lrs))],
                   "unfusedVsCudnnOff": _grad_gap(runs[True][0], grads)}}
        for i in range(len(lrs)):
            srel = {k: _rel_l2(torch, fstats[k][i], v)
                    for k, v in stats.items()}
            ftrain = float(fmetrics["loss"][0][i] / fmetrics["loss"][1][i])
            out["configs"].append({
                "trainLossRel": abs(ftrain - train) / abs(train),
                "evalLossRel": abs(float(floss[i]) - float(loss)) /
                abs(float(loss)),
                "gradRelL2": _grad_gap(fgrads, grads, i),
                "statsRelL2Max": max(srel.values()) if srel else 0.0,
                "gradients": len(grads), "statistics": len(srel)})
        return out
    finally:
        os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
        torch.backends.cudnn.allow_tf32 = tf32


def fusion_phase(torch, log, home, yard):
    """Sweep fusion on the card (the ``fusion`` line): (a) workflow 2's
    GridSearch (the tutorial CNN over 1024 MNIST-shaped rows,
    ``learning_rate`` 1e-3/3e-4 x ``batch_size`` 128/256, 1 epoch)
    through ``/model`` and ``/tune``, fused and with
    ``LO_SWEEP_FUSION=0``, in bf16 and in float32 (TF32 off): 2 cohorts,
    ``fusedTrials`` 4, ``fallbackTrials`` 0; in float32 each point's
    metrics within 1e-4 of the unfused run's and the same
    ``best_params_`` (bf16's gaps recorded); both sweeps' seconds, and the
    kernels the card runs an optimizer step (bf16) fused (2 configs) and
    unfused (1); (b) BASELINE
    config 5's sweep: ResNet-50 (1000 classes, 224x224x3) made through
    ``tensorflow.keras.applications`` and swept over two learning rates
    on 64 images at batch 32, fused and unfused under the same checks
    but the 1e-4 bound, in bf16 and in float32 with cuDNN off:
    ResNet-50's gradient at init is ill-conditioned (cuDNN's algorithms
    move it by percents) and Adam's first steps amplify the rest, so its
    points' gaps are recorded and the fused first step is held instead,
    in float32 with cuDNN off: each config's train and inference loss,
    its whole gradient and every new batch statistic within 1e-4
    (relative) of the unfused step's (with cuDNN on, the gaps are
    recorded); every batch statistic of each
    fused config moved; (c) the
    IMDb-shaped LSTM (2048 rows of 200 ids, batch 128) over two learning
    rates, fused and unfused under the same checks; (d) an early-stop
    margin (0.05 from epoch 1) that freezes the trailing config of a CNN
    cohort over 4 epochs, its stopped epoch; (e) ``/metrics``
    ``sweepFusion`` moved by the sum of the phase's ``fusion_info_``.
    Every fused cohort ran on CUDA tensors, the card's memory is back
    within 1 MiB after each cohort (the probes' seconds are taken out of
    the sweeps' seconds), and no flash kernel launches."""
    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models.neural import NeuralModel
    from learningorchestra_tpu_torch.models.sweep import GridSearch
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime import engine as engine_lib
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    phase_t0 = time.monotonic()
    out, problems = {}, []
    zero = dict.fromkeys(COUNTERS, 0)
    cohort_mem, cohorts = [], []
    real_cohort = GridSearch._run_fused_cohort
    real_fit_fused = engine_lib.FusedEngine.fit_fused

    probe_s = [0.0]  # the memory probes' own seconds, kept out of timings

    def measured_cohort(self, *args, **kwargs):
        t0 = time.monotonic()
        before = _card_bytes(torch)
        t1 = time.monotonic()
        try:
            return real_cohort(self, *args, **kwargs)
        finally:
            t2 = time.monotonic()
            cohort_mem.append({"beforeBytes": before,
                               "afterBytes": _card_bytes(torch),
                               "cohortSeconds": t2 - t1})
            probe_s[0] += (t1 - t0) + (time.monotonic() - t2)

    def watched_fit_fused(self, state, *args, **kwargs):
        init = {k: v.detach().clone() for k, v in state.model_state.items()}
        on_card = all(p.is_cuda for p in state.params.values())
        res = real_fit_fused(self, state, *args, **kwargs)
        final = res[0].model_state
        cohorts.append({
            "configs": self.n_configs, "onCard": on_card,
            "statistics": len(init), "stoppedEpochs": res[3],
            "statisticsMovedPerConfig": [
                sum(not torch.equal(final[k][i], init[k][i]) for k in init)
                for i in range(self.n_configs)]})
        del init, final
        return res

    _reset_launches(attn)
    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    infos = []

    def post(path, body):
        got, answer = _http(base, "POST", path, body)
        if got != 201:
            raise AssertionError(f"POST {path}: {got} {answer}")

    def model(name, module, cls, params):
        post("/model/tensorflow", {"modelName": name, "modulePath": module,
                                   "class": cls, "classParameters": params})
        _poll(base, f"/model/tensorflow/{name}")

    def tune(name, estimator, grid, data, params, fused):
        """A GridSearch of ``grid`` over ``$estimator`` on ``/tune``:
        (seconds, metadata, the fitted sweep)."""
        os.environ["LO_SWEEP_FUSION"] = "1" if fused else "0"
        model(name, "learningorchestra_tpu.models", "GridSearch",
              {"estimator": f"${estimator}", "param_grid": grid})
        t0, probes = time.monotonic(), probe_s[0]
        post("/tune/tensorflow", {"name": f"{name}_t", "modelName": name,
                                  "method": "fit", "methodParameters": dict(
                                      params, x=f"${data}.x",
                                      y=f"${data}.y")})
        meta = _poll(base, f"/tune/tensorflow/{name}_t")
        seconds = time.monotonic() - t0 - (probe_s[0] - probes)
        infos.append(meta["sweepFusion"])
        return seconds, meta, ctx.artifacts.load(f"{name}_t")

    def hold(case, mode, fused_run, unfused_run, points, n_cohorts,
             checked, bounded):
        """The checks of one fused/unfused pair; in the ``checked`` mode
        equal best params and, where ``bounded``, each point within
        1e-4."""
        (fs, fmeta, fused), (us, umeta, unfused) = fused_run, unfused_run
        info = fmeta["sweepFusion"]
        want = {"fusedTrials": points, "cohorts": n_cohorts,
                "fallbackTrials": 0, "earlyStopped": 0}
        gaps = _sweep_gaps(fused, unfused)
        if info != want or umeta["sweepFusion"]["fusedTrials"] != 0 or \
                not gaps["samePoints"]:
            problems.append(f"{case} {mode}: sweepFusion {info}, unfused "
                            f"{umeta['sweepFusion']}, want {want}")
        if mode == checked and (
                fused.best_params_ != unfused.best_params_ or bounded and
                not max(gaps["maxGapPerPoint"]) <= FUSION_TOL):
            problems.append(f"{case} {mode}: fused vs unfused {gaps}")
        return dict(gaps, sweepFusion=info, fusedSeconds=fs,
                    unfusedSeconds=us)

    def all_modes(case, run_pair, points, n_cohorts,
                  modes=("bfloat16", "float32"), bounded=True):
        """``run_pair(mode)`` -> (fused run, unfused run), in each of
        ``modes`` (FUSION_MODES; float32 without TF32), the last one
        checked."""
        result = {}
        for mode in modes:
            dtype, cudnn = FUSION_MODES[mode]
            os.environ["LO_COMPUTE_DTYPE"] = dtype
            torch.backends.cudnn.allow_tf32 = dtype != "float32"
            torch.backends.cudnn.enabled = cudnn
            try:
                pair = run_pair(mode)
            finally:
                os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
                torch.backends.cudnn.allow_tf32 = tf32
                torch.backends.cudnn.enabled = True
            result[mode] = hold(case, mode, *pair, points=points,
                                n_cohorts=n_cohorts, checked=modes[-1],
                                bounded=bounded)
            del pair
            gc.collect()
        return result

    def per_step(fn, steps):
        _, n = _device_launches(torch, fn)
        return n / steps

    tf32 = torch.backends.cudnn.allow_tf32
    GridSearch._run_fused_cohort = measured_cohort
    engine_lib.FusedEngine.fit_fused = watched_fit_fused
    try:
        before = json.loads(_raw(base, "/metrics")[1])["sweepFusion"]

        # (a) workflow 2's GridSearch over REST, fused and unfused
        rx, ry = _mnist_like(np, REST_ROWS, seed=1)
        # the card's kernels an optimizer step (one step trains both
        # configs fused, one config unfused), after a first use of each
        # path, timed apart from the sweeps
        cnn = NeuralModel(TUTORIAL_CNN, device="cuda")
        cnn._build_params(rx[:1])
        batch = SWEEP_GRID["batch_size"][0]
        steps = -(-REST_ROWS // batch)
        hyper = [{"learning_rate": v} for v in SWEEP_GRID["learning_rate"]]
        first_use = {}
        for name, fn in (("fused", lambda: cnn.fit_sweep_fused(
                rx, ry, hyper, batch_size=batch, epochs=1)),
                ("unfused", lambda: cnn.fit(rx, ry, batch_size=batch,
                                            epochs=1))):
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            first_use[name] = time.monotonic() - t0
        launches_per_step = {
            "fused2Configs": per_step(lambda: cnn.fit_sweep_fused(
                rx, ry, hyper, batch_size=batch, epochs=1), steps),
            "unfused1Config": per_step(lambda: cnn.fit(
                rx, ry, batch_size=batch, epochs=1), steps),
            "batch": batch, "steps": steps,
            "firstUseSeconds": first_use}
        del cnn
        _save_arrays(ctx, "mnist", {"x": rx, "y": ry})
        model("cnn", "learningorchestra_tpu.models", "NeuralModel",
              {"layer_configs": TUTORIAL_CNN})
        out["cnn"] = all_modes("cnn", lambda mode: [
            tune(f"cnn_{mode}_{int(f)}", "cnn", SWEEP_GRID, "mnist",
                 {"epochs": 1}, f) for f in (True, False)], 4, 2)
        out["cnn"]["launchesPerStep"] = launches_per_step

        # (b) BASELINE config 5's sweep
        rng = np.random.default_rng(5)
        images = rng.standard_normal((RESNET_TUNE_IMAGES, 224, 224, 3),
                                     dtype=np.float32)
        labels = rng.integers(0, 1000, RESNET_TUNE_IMAGES).astype(np.int32)
        _save_arrays(ctx, "rn_data", {"x": images, "y": labels})
        model("rn", "tensorflow.keras.applications", "ResNet50",
              {"input_shape": [224, 224, 3]})
        n_before = len(cohorts)
        # ResNet-50's gradient at init is ill-conditioned: cuDNN's
        # algorithms move it by percents against PyTorch's own
        # convolutions, and cuDNN's grouped ones (the fused path's)
        # another way (the first step records both), and Adam's first
        # steps amplify what is left; so its sweep's points are recorded
        # (float32 with cuDNN off, where only the summation order
        # differs) and its first step is held to 1e-4
        modes = ("bfloat16", "float32CudnnOff")
        out["baseline5"] = all_modes("baseline5", lambda mode: [
            tune(f"rn_{mode}_{int(f)}", "rn", {
                "learning_rate": KERAS_LR_GRID}, "rn_data",
                {"epochs": 1, "batch_size": RESNET_PRE_BATCH}, f)
            for f in (True, False)], 2, 1, modes=modes, bounded=False)
        first = _fused_first_step(
            torch, ctx.artifacts.load("rn").layer_configs,
            images[:RESNET_PRE_BATCH], labels[:RESNET_PRE_BATCH],
            KERAS_LR_GRID)
        out["baseline5"]["firstStepFloat32"] = first
        if not all(c["trainLossRel"] <= FUSION_TOL and
                   c["evalLossRel"] <= FUSION_TOL and
                   c["gradRelL2"] <= FUSION_TOL and
                   c["statsRelL2Max"] <= FUSION_TOL and c["statistics"]
                   for c in first["configs"]):
            problems.append(f"baseline5: the fused first step {first}")
        del images
        rn_cohorts = cohorts[n_before:]
        out["baseline5"]["fusedCohorts"] = rn_cohorts
        if len(rn_cohorts) != len(modes) or any(
                c["statistics"] == 0 or any(
                    m != c["statistics"]
                    for m in c["statisticsMovedPerConfig"])
                for c in rn_cohorts):
            problems.append(f"baseline5: batch statistics {rn_cohorts}")

        # (c) the IMDb-shaped LSTM, direct
        ix, iy = _imdb_like(np, FUSION_LSTM_ROWS, seed=3)

        def lstm_pair(mode):
            pair = []
            for fused in (True, False):
                os.environ["LO_SWEEP_FUSION"] = "1" if fused else "0"
                est = NeuralModel(TUTORIAL_LSTM, device="cuda")
                est.compile({"kind": "adam", "learning_rate": 1e-3})
                t0, probes = time.monotonic(), probe_s[0]
                sweep = GridSearch(est, FUSION_LSTM_GRID,
                                   device="cuda").fit(
                    ix, iy, epochs=1, batch_size=IMDB_BATCH)
                seconds = time.monotonic() - t0 - (probe_s[0] - probes)
                infos.append(sweep.fusion_info_)
                pair.append((seconds, {"sweepFusion": sweep.fusion_info_},
                             sweep))
            return pair

        out["lstm"] = all_modes("lstm", lstm_pair, 2, 1)
        lstm = NeuralModel(TUTORIAL_LSTM, device="cuda")
        lstm._build_params(lstm._coerce_x(ix[:1]))
        steps = -(-FUSION_LSTM_ROWS // IMDB_BATCH)
        hyper = [{"learning_rate": v}
                 for v in FUSION_LSTM_GRID["learning_rate"]]
        out["lstm"]["launchesPerStep"] = {
            "fused2Configs": per_step(lambda: lstm.fit_sweep_fused(
                ix, iy, hyper, batch_size=IMDB_BATCH, epochs=1), steps),
            "unfused1Config": per_step(lambda: lstm.fit(
                ix, iy, batch_size=IMDB_BATCH, epochs=1), steps),
            "batch": IMDB_BATCH, "steps": steps,
            "route": "folded: one cuDNN RNN call for every config, the "
                     "config axis block-diagonal in the hidden axis"}
        del lstm, ix

        # (d) early stop freezes the trailing config
        os.environ.update(LO_SWEEP_FUSION="1",
                          LO_SWEEP_EARLYSTOP_MARGIN="0.05",
                          LO_SWEEP_EARLYSTOP_MIN_EPOCHS="1")
        try:
            est = NeuralModel(TUTORIAL_CNN, device="cuda")
            stopped = GridSearch(est, EARLYSTOP_GRID, refit=False,
                                 device="cuda").fit(
                rx, ry, epochs=EARLYSTOP_EPOCHS, batch_size=EARLYSTOP_BATCH)
        finally:
            for key in ("LO_SWEEP_EARLYSTOP_MARGIN",
                        "LO_SWEEP_EARLYSTOP_MIN_EPOCHS"):
                os.environ.pop(key, None)
        infos.append(stopped.fusion_info_)
        epochs_at = cohorts[-1]["stoppedEpochs"]
        out["earlyStop"] = {
            "grid": EARLYSTOP_GRID, "epochs": EARLYSTOP_EPOCHS,
            "margin": 0.05, "sweepFusion": stopped.fusion_info_,
            "stoppedEpochs": epochs_at,
            "metrics": stopped.cv_results_["metrics"],
            "bestParams": stopped.best_params_}
        if stopped.fusion_info_["earlyStopped"] != 1 or epochs_at[0] is not \
                None or not (epochs_at[1] or 0) >= 1 or \
                stopped.best_params_ != {
                    "learning_rate": EARLYSTOP_GRID["learning_rate"][0]}:
            problems.append(f"early stop: {out['earlyStop']}")

        # (e) /metrics moved by the phase's sweeps
        after = json.loads(_raw(base, "/metrics")[1])["sweepFusion"]
        moved = {k: after[k] - before[k] for k in FUSION_KEYS}
        summed = {k: sum(i[k] for i in infos) for k in FUSION_KEYS}
        out["metrics"] = {"moved": moved, "sumOfRuns": summed,
                          "fusedEpochTraces": after["fusedEpochTraces"] -
                          before["fusedEpochTraces"]}
        if moved != summed:
            problems.append(f"/metrics sweepFusion moved {moved}, the runs "
                            f"sum to {summed}")
    finally:
        GridSearch._run_fused_cohort = real_cohort
        engine_lib.FusedEngine.fit_fused = real_fit_fused
        torch.backends.cudnn.allow_tf32 = tf32
        os.environ["LO_SWEEP_FUSION"] = "1"
        server.stop()
        ctx.close()
    out["cohorts"] = cohorts
    out["cohortMemory"] = cohort_mem
    out["memoryProbeSeconds"] = probe_s[0]
    leaked = [m for m in cohort_mem
              if abs(m["afterBytes"] - m["beforeBytes"]) > 1 << 20]
    if leaked or not cohort_mem:
        problems.append(f"card memory after a cohort: {cohort_mem}")
    if not cohorts or not all(c["onCard"] for c in cohorts):
        problems.append(f"fused cohorts off the card: {cohorts}")
    launched = _launches(attn)
    if launched != zero:
        problems.append(f"the fusion phase launched {launched}")
    out["launches"] = launched
    out["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("fusion " + json.dumps(out))
    if problems:
        raise AssertionError("; ".join(problems))
    return {"fusion": launched}


# ----------------------------------------------------------------------
# checkpoints committed off the training thread
# ----------------------------------------------------------------------
CKPT_SHARDS = 4


def _manifests(ck_dir: str) -> dict:
    """Each committed step's manifest files (name -> sha256 and bytes)."""
    out = {}
    for name in sorted(os.listdir(ck_dir)):
        if name.isdigit():
            with open(os.path.join(ck_dir, name, "manifest.json")) as f:
                out[int(name)] = json.load(f)["files"]
    return out


def _same_tree(np, a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            _same_tree(np, a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


def ckpt_async_phase(torch, log, home, yard):
    """The checkpointed REST fit of the tutorial LM (bf16, 8 optimizer
    steps, a 771 MB step) under ``LO_CKPT_ASYNC=1`` (the ``ckptAsync``
    line): the losses of the synchronous fit bit for bit (the pipeline
    phase's, else one run here), each step dir's payload files equal to
    the synchronous run's (sha256 and bytes), exactly 128 launches of each
    sm90 kernel; the train thread's stall a save (the snapshot) and the
    commit's own seconds beside the synchronous commit's; a 1-epoch fit
    PATCHed to 2 from the async steps equal to the uninterrupted fit;
    ``ckpt_async_commit:1`` fails its job with an ``AsyncCheckpointError``
    document and the next fit runs; a ``shards=4`` copy of a step dir
    round-trips; an engine with another optimizer kind resumes the saved
    params and step with a fresh optimizer state."""
    import warnings

    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime.checkpoint import Checkpointer
    from learningorchestra_tpu_torch.services import faults
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    phase_t0 = time.monotonic()
    x = yard.get("x")
    if x is None:
        x = _successor_windows(np, TRAIN_WINDOWS, TRAIN_SEQ, seed=0)
    steps = TRAIN_EPOCHS * TRAIN_WINDOWS // TRAIN_BATCH
    per_epoch = steps // TRAIN_EPOCHS
    ctx = ServiceContext(Config(home=os.path.join(home, "lo"),
                                ckpt_async=True), device="cuda")
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    ck_root = ctx.config.checkpoints_dir
    out, launches = {}, {}

    def need(n_steps):
        want = dict.fromkeys(COUNTERS, 0)
        want.update(dict.fromkeys(
            ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
            LM_CONFIG["n_layers"] * n_steps * TRAIN_ACCUM))
        return want

    def job(name, params, patch=False):
        """POST (or PATCH) a fit and wait for it: (seconds, metadata, its
        epoch records, launches)."""
        _reset_launches(attn)
        n_docs = len(ctx.catalog.get_documents(name)) if patch else 0
        t0 = time.monotonic()
        if patch:
            status, answer = _http(base, "PATCH", f"/train/tensorflow/{name}",
                                   {"methodParameters": params})
            if status != 200:
                raise AssertionError(f"PATCH {name}: {status} {answer}")
        else:
            status, answer = _http(base, "POST", "/train/tensorflow", {
                "name": name, "modelName": "lm", "method": "fit",
                "methodParameters": params})
            if status != 201:
                raise AssertionError(f"POST {name}: {status} {answer}")
        ctx.jobs.wait(name, timeout=600)
        wall = time.monotonic() - t0
        ran = _launches(attn)
        docs = ctx.catalog.get_documents(name)[n_docs:]
        records = [d["epochRecord"] for d in docs if "epochRecord" in d]
        return wall, ctx.catalog.get_metadata(name), records, ran, docs

    fit = {"x": "$corpus.tokens", "batch_size": TRAIN_BATCH,
           "epochs": TRAIN_EPOCHS, "grad_accum": TRAIN_ACCUM,
           "checkpoint": True}
    try:
        _save_arrays(ctx, "corpus", {"tokens": x})
        status, answer = _http(base, "POST", "/model/tensorflow", {
            "modelName": "lm", "modulePath": "learningorchestra_tpu.models",
            "class": "LanguageModel", "classParameters": LM_CONFIG})
        if status != 201:
            raise AssertionError(f"POST /model: {status} {answer}")
        _poll(base, "/model/tensorflow/lm")

        sync = yard.get("syncCheckpoint")
        if sync is None:
            ctx.config.ckpt_async = False
            wall, meta, records, ran, _ = job("lm_sync", fit)
            ctx.config.ckpt_async = True
            sync = {"losses": [r["loss"] for r in records],
                    "manifests": _manifests(os.path.join(ck_root,
                                                         "lm_sync")),
                    "commitSeconds": [c["seconds"] for c in
                                      meta["checkpointCommits"]],
                    "fitWallSeconds": wall, "source": "this phase"}
        out["sync"] = {k: v for k, v in sync.items() if k != "manifests"}

        # the async fit
        wall, meta, records, launches["ckptAsyncFit"], _ = job("lm_t", fit)
        losses = [r["loss"] for r in records]
        manifests = _manifests(os.path.join(ck_root, "lm_t"))
        snaps = meta.get("checkpointSnapshots", [])
        commits = meta.get("checkpointCommits", [])
        if losses != sync["losses"]:
            raise AssertionError(f"async fit losses {losses}, synchronous "
                                 f"{sync['losses']}")
        if {str(k): v for k, v in manifests.items()} != \
                {str(k): v for k, v in sync["manifests"].items()}:
            raise AssertionError(f"async step dirs {manifests} differ from "
                                 f"the synchronous {sync['manifests']}")
        if launches["ckptAsyncFit"] != need(steps):
            raise AssertionError(f"async fit launched "
                                 f"{launches['ckptAsyncFit']}")
        if [s["step"] for s in snaps] != [per_epoch * (e + 1) for e in
                                          range(TRAIN_EPOCHS)] or \
                [c["step"] for c in commits] != [s["step"] for s in snaps]:
            raise AssertionError(f"snapshots {snaps}, commits {commits}")
        out["async"] = {
            "losses": losses, "lossesEqualSync": True,
            "payloadFilesEqualSync": True, "fitWallSeconds": wall,
            "epochSeconds": [r["epochSeconds"] for r in records],
            "snapshotSeconds": [s["seconds"] for s in snaps],
            "snapshotBytes": [s["bytes"] for s in snaps],
            "commitSeconds": [c["seconds"] for c in commits],
            "commitBytes": [c["bytes"] for c in commits],
            "checkpointSnapshotSeconds": meta["checkpointSnapshotSeconds"],
            "checkpointCommitSeconds": meta["checkpointCommitSeconds"],
            "launches": launches["ckptAsyncFit"]}

        # a commit that fails on the worker fails its job
        ctx.config.fault_inject = "ckpt_async_commit:1"
        faults.reset()
        try:
            _, meta_f, _, launches["ckptAsyncFault"], docs = job(
                "lm_fault", dict(fit, epochs=1))
        finally:
            ctx.config.fault_inject = ""
            faults.reset()
        failed = [d for d in docs if d.get("exception")]
        if meta_f.get("finished") or not failed or \
                "AsyncCheckpointError" not in failed[-1]["exception"]:
            raise AssertionError(f"the faulted commit's job: {meta_f} "
                                 f"{docs[-3:]}")
        out["faultedCommit"] = {"status": meta_f.get("status"),
                                "exception": failed[-1]["exception"][:300]}

        # the next fit runs: 1 epoch, then PATCHed to 2 from its async
        # step
        _, _, first, launches["ckptAsyncResumeFirst"], _ = job(
            "lm_rs", dict(fit, epochs=1))
        wall_r, meta_r, second, launches["ckptAsyncResume"], _ = job(
            "lm_rs", fit, patch=True)
        resumed = ctx.artifacts.load("lm_rs")
        trained = ctx.artifacts.load("lm_t")
        same = all(torch.equal(resumed.params[k], trained.params[k])
                   for k in trained.params)
        if [r["loss"] for r in first] != losses[:1] or \
                [r["loss"] for r in second] != losses[1:] or not same or \
                launches["ckptAsyncResume"] != need(per_epoch) or \
                not meta_r.get("checkpointRestores"):
            raise AssertionError(f"async resume: {first} {second}, params "
                                 f"equal {same}, "
                                 f"{launches['ckptAsyncResume']}, {meta_r}")
        out["resume"] = {"losses": [r["loss"] for r in first + second],
                         "paramsEqualUninterrupted": same,
                         "patchWallSeconds": wall_r,
                         "restores": meta_r["checkpointRestores"]}
        del resumed

        # a shards=4 copy of the async run's newest step round-trips
        tree = Checkpointer(os.path.join(ck_root, "lm_t")).saved_metadata(
            steps)
        sharded = Checkpointer(os.path.join(home, "sharded"),
                               shards=CKPT_SHARDS)
        t0 = time.monotonic()
        sharded.save(steps, tree)
        save_s = time.monotonic() - t0
        files = _manifests(os.path.join(home, "sharded"))[steps]
        t0 = time.monotonic()
        back = Checkpointer(os.path.join(home, "sharded")).restore(tree)
        restore_s = time.monotonic() - t0
        if len(files) != CKPT_SHARDS or not _same_tree(np, back, tree):
            raise AssertionError(f"shards={CKPT_SHARDS}: files {files}")
        out["sharded"] = {"shards": CKPT_SHARDS, "saveSeconds": save_s,
                          "restoreSeconds": restore_s,
                          "bytesPerShard": [f["bytes"]
                                            for f in files.values()]}
        del tree, back

        # another optimizer kind: the saved params, a fresh optimizer
        trained.compile({"kind": "sgd", "learning_rate": 1e-3})
        eng = trained._get_engine()
        state = eng.init_state({k: torch.zeros_like(v).requires_grad_(
            v.requires_grad) for k, v in trained.params.items()})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            migrated = eng._maybe_restore(
                state, Checkpointer(os.path.join(ck_root, "lm_t")))
        said = [str(w.message) for w in caught]
        grafted = all(torch.equal(state.params[k], trained.params[k])
                      for k in trained.params)
        fresh = set(state.opt_state) == {"trace"} and all(
            not t.any() for t in state.opt_state["trace"].values())
        if not (migrated and grafted and fresh and state.step == steps and
                any("rebuilt optimizer state fresh" in m for m in said)):
            raise AssertionError(f"params-only migration: {migrated} "
                                 f"{grafted} {fresh} {state.step} {said}")
        out["migration"] = {"from": "adamw", "to": "sgd", "step": state.step,
                            "paramsEqualSaved": grafted,
                            "optimizerStateFresh": fresh,
                            "warning": [m for m in said
                                        if "rebuilt" in m][0][:200]}
        del state, eng, trained
    finally:
        server.stop()
        ctx.close()
        shutil.rmtree(ck_root, ignore_errors=True)
    out["launches"] = launches
    out["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("ckptAsync " + json.dumps(out))
    gc.collect()
    return launches


# ----------------------------------------------------------------------
# the function route: the tutorial's workflows as written, through the
# port's own client
# ----------------------------------------------------------------------
FN_MNIST_ROWS, FN_IMDB_ROWS, TITANIC_ROWS = 1024, 1024, 891
# docs/TUTORIAL.md's function bodies, as written
TITANIC_PREP = (
    "import numpy as np\n"
    "df = df.dropna(subset=['Age'])\n"
    "x = df[['Pclass', 'Age', 'SibSp', 'Parch', 'Fare']]"
    ".to_numpy('float32')\n"
    "y = df['Survived'].to_numpy('int32')\n"
    "response = {'x': x, 'y': y}\n")
MNIST_ARRAYS = (
    "import numpy as np\n"
    "x = df.drop(columns=['label']).to_numpy('float32') / 255.0\n"
    "y = df['label'].to_numpy('int32')\n"
    "response = {'x': x, 'y': y}\n")
# the same step over the port's Table, where the jailed child has no pandas
MNIST_ARRAYS_NUMPY = (
    "import numpy as np\n"
    "x = np.stack([df[c] for c in df.columns if c != 'label'], axis=1)"
    ".astype('float32') / 255.0\n"
    "y = df['label'].astype('int32')\n"
    "response = {'x': x, 'y': y}\n")
# the step the tutorial reads as $imdb_tokens and does not show: ids in
# [2, 20000), and in the rows labelled 1 an eighth of them the marker 1
IMDB_TOKENS = (
    "import numpy as np\n"
    "rng = np.random.default_rng(seed)\n"
    "x = rng.integers(2, 20000, size=(rows, seq)).astype('int32')\n"
    "y = rng.integers(0, 2, size=rows).astype('int32')\n"
    "marked = (rng.random((rows, seq)) < 0.125) & (y[:, None] == 1)\n"
    "x[marked] = 1\n"
    "response = {'x': x, 'y': y}\n")
# what the jailed child can import
SANDBOX_PROBE = (
    "response = {'pandas': None, 'sklearn': None}\n"
    "try:\n"
    "    import pandas\n"
    "    response['pandas'] = pandas.__version__\n"
    "except Exception:\n"
    "    pass\n"
    "try:\n"
    "    import sklearn\n"
    "    response['sklearn'] = sklearn.__version__\n"
    "except Exception:\n"
    "    pass\n")
# whether a jailed child that imports torch sees a card
CARDLESS_PROBE = (
    "import torch\n"
    "response = {'cuda': torch.cuda.is_available(),"
    " 'devices': torch.cuda.device_count(), 'torch': torch.__version__}\n")
SMUGGLE = ("name = '__subcl' + 'asses__'\n"
           "response = getattr((), name)\n")


def _observe_wait(client, name: str, timeout: float = 600.0) -> dict:
    """``ctx.wait`` through the client's ``/observe`` long-poll, except
    that a job which dead-letters returns at once (``ctx.wait`` would
    wait out its timeout): the metadata, with the job's last document
    as ``failedDocument`` where it failed."""
    deadline = time.monotonic() + timeout
    seq = 0
    while time.monotonic() < deadline:
        result = client.observe(name, seq=seq, timeout=min(
            25.0, max(0.1, deadline - time.monotonic())))
        meta = result.get("metadata") or {}
        if meta.get("finished"):
            return meta
        if meta.get("status") == "deadLettered":
            return dict(meta, failedDocument=client.tool(
                *meta["type"].split("/")).read(name)["result"][-1])
        seq = result["seq"]
    raise AssertionError(f"{name} did not finish in {timeout} s")


def _fn_mnist(np, path):
    """1024 rows of the label and 784 integer pixels (a class template
    mixed with noise, as _mnist_like draws them), written as a CSV."""
    x, y = _mnist_like(np, FN_MNIST_ROWS, seed=2)
    pixels = np.floor(x * 255).astype(np.int64)
    with open(path, "w") as f:
        f.write("label," + ",".join(f"pixel{i}" for i in range(784)) + "\n")
        for label, row in zip(y, pixels):
            f.write(f"{label}," + ",".join(map(str, row)) + "\n")
    return pixels, y


def _fn_titanic(np, path) -> None:
    """Titanic's published columns and row count, from a seed: Pclass,
    Age with a fifth blank, SibSp, Parch, Fare, Survived."""
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        f.write("Pclass,Age,SibSp,Parch,Fare,Survived\n")
        for _ in range(TITANIC_ROWS):
            pclass = int(rng.integers(1, 4))
            age = "" if rng.random() < 0.2 else f"{rng.uniform(0.4, 80):.1f}"
            fare = rng.gamma(2.0, 40.0 / pclass)
            survived = int(rng.random() < 0.75 - 0.2 * pclass + fare / 400)
            f.write(f"{pclass},{age},{int(rng.integers(0, 6))},"
                    f"{int(rng.integers(0, 5))},{fare:.4f},{survived}\n")


def function_phase(torch, log, home, yard):
    """The function route on the card (the ``function`` line): the port's
    REST server driven by the port's ``client.Context`` in the default
    subprocess sandbox. (a) workflow 2 as written, its ``/train`` losses
    against a direct fit; (c) the jail (a child without the card, a lint
    406, a smuggled dunder that fails its job); (b) workflow 3's LSTM and
    the tutorial TextClassifier fitted over REST on a function step's
    tokens with a ``#`` batch size, whose sm90 launches must be exactly 4
    layers x 8 steps (dq, dK/dV) and 4 x 16 (forward: the fit and the
    evaluate), and whose loss equals a direct fit's; (d) workflow 1 where
    the child has sklearn and pandas; (e) job seconds, the spawn share,
    ``ctx.wait``'s latency. Returns the classifier path's launches."""
    import numpy as np

    from learningorchestra_tpu_torch import client as lo_client
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights as weights_lib
    from learningorchestra_tpu_torch.models.encoder import TextClassifier
    from learningorchestra_tpu_torch.models.neural import NeuralModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    phase_t0 = time.monotonic()
    out: dict = {"jobSeconds": {}, "jobChildSeconds": {}}
    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    if ctx.config.sandbox_mode != "subprocess":
        raise AssertionError(f"sandbox mode {ctx.config.sandbox_mode}")
    server = RestServer(port=0, context=ctx).start()
    client = lo_client.Context(server.base_url)
    models = "learningorchestra_tpu.models"

    def finished(name, meta):
        if not meta.get("finished"):
            raise AssertionError(f"job {name} failed: "
                                 f"{meta.get('failedDocument')}")
        return meta

    posted = {}

    def function(name, body=None, params=None):
        """POSTs function ``name`` (unless ``body`` is None: it was
        posted before) and waits for it; its artifact."""
        if body is not None:
            posted[name] = time.monotonic()
            client.function_python.run_function(name, body, params)
        finished(name, _observe_wait(client, name))
        out["jobSeconds"][name] = time.monotonic() - posted[name]
        # the job flips finished, then appends its execution document
        for _ in range(500):
            last = client.function_python.read(name)["result"][-1]
            if "elapsedSeconds" in last:
                out["jobChildSeconds"][name] = last["elapsedSeconds"]
                break
            time.sleep(0.01)
        return ctx.artifacts.load(name, "function/python")

    def execution(tool, name, parent, method, params):
        tool.run(name, parent, method, params)
        return finished(name, _observe_wait(client, name))

    def epoch_losses(tool, name):
        return [d["epochRecord"]["loss"] for d in tool.read(name)["result"]
                if "epochRecord" in d]

    try:
        # (c) starts first: the child that imports torch (seconds) runs
        # on the host while (a) uses the card
        posted["cardless"] = time.monotonic()
        client.function_python.run_function("cardless", CARDLESS_PROBE, {})
        # (a) workflow 2 as written
        mnist_csv = os.path.join(home, "mnist.csv")
        pixels, labels = _fn_mnist(np, mnist_csv)
        t0 = time.monotonic()
        client.dataset_csv.insert("mnist", mnist_csv)
        finished("mnist", _observe_wait(client, "mnist"))
        out["ingestSeconds"] = time.monotonic() - t0
        probe = function("probe", SANDBOX_PROBE, {})
        out["child"] = dict(probe)
        body = MNIST_ARRAYS if probe["pandas"] else MNIST_ARRAYS_NUMPY
        out["mnistBody"] = "tutorial (pandas)" if probe["pandas"] \
            else "numpy over the Table"
        arrays = function("mnist_arrays", body, {"df": "$mnist"})
        x, y = arrays["x"], arrays["y"]
        want_x = pixels.astype(np.float32) / 255.0
        if not (x.dtype == np.float32 and np.array_equal(x, want_x)
                and np.array_equal(y, labels)):
            raise AssertionError(f"mnist_arrays: {x.dtype} {x.shape}, "
                                 f"equal {np.array_equal(x, want_x)}")
        client.model_tensorflow.create("cnn", models, "NeuralModel",
                                       {"layer_configs": TUTORIAL_CNN})
        finished("cnn", _observe_wait(client, "cnn"))
        fit = {"x": "$mnist_arrays.x", "y": "$mnist_arrays.y", "epochs": 4,
               "batch_size": 256, "checkpoint": True}
        t0 = time.monotonic()
        meta = execution(client.train_tensorflow, "cnn_t", "cnn", "fit", fit)
        out["cnnTrainJobSeconds"] = time.monotonic() - t0
        got = epoch_losses(client.train_tensorflow, "cnn_t")
        execution(client.evaluate_tensorflow, "cnn_e", "cnn_t", "evaluate",
                  {"x": "$mnist_arrays.x", "y": "$mnist_arrays.y"})
        cnn_eval = next(d["result"] for d in client.evaluate_tensorflow.read(
            "cnn_e")["result"] if "result" in d)
        want = NeuralModel(TUTORIAL_CNN, device="cuda").fit(
            x, y, batch_size=256, epochs=4).history["loss"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if len(got) != 4 or not rel <= 1e-5 or \
                len(meta.get("checkpointCommits", [])) != 4:
            raise AssertionError(f"the CNN's REST losses {got} against the "
                                 f"direct fit's {want}; metadata {meta}")
        out["cnn"] = {"losses": got, "directLosses": want,
                      "maxRelToDirect": rel, "bitEqualToDirect": got == want,
                      "evaluate": cnn_eval}

        # (c) the jail on the card
        cardless = function("cardless")
        out["child"].update(cardless)
        if cardless["cuda"] is not False or cardless["devices"] != 0:
            raise AssertionError(f"the jailed child sees a card: "
                                 f"{cardless}")
        try:
            client.function_python.run_function(
                "passwd", "response = open('/etc/passwd').read()\n", {})
            raise AssertionError("open('/etc/passwd') was accepted")
        except lo_client.ApiError as err:
            if err.status != 406 or ctx.catalog.exists("passwd"):
                raise AssertionError(f"open('/etc/passwd'): {err}")
            refused = err.message
        client.function_python.run_function("smuggle", SMUGGLE, {})
        smuggled = _observe_wait(client, "smuggle")
        exception = (smuggled.get("failedDocument") or {}).get(
            "exception") or ""
        if smuggled.get("finished") or "AttributeError" not in exception \
                or "blocked in sandboxed code" not in exception:
            raise AssertionError(f"the smuggled dunder: {smuggled}")
        out["jail"] = {"childCuda": cardless["cuda"],
                       "passwdAt406": refused,
                       "smuggleError": exception.split("\\n")[0]}

        # (b) workflow 3, then the classifier's REST fit on the tokens
        function("imdb_tokens", IMDB_TOKENS,
                 {"rows": FN_IMDB_ROWS, "seq": 200, "seed": 0})
        client.model_tensorflow.create("lstm", models, "NeuralModel",
                                       {"layer_configs": TUTORIAL_LSTM})
        finished("lstm", _observe_wait(client, "lstm"))
        execution(client.train_tensorflow, "lstm_t", "lstm", "fit",
                  {"x": "$imdb_tokens.x", "y": "$imdb_tokens.y",
                   "epochs": 3, "batch_size": 128})
        lstm_losses = epoch_losses(client.train_tensorflow, "lstm_t")
        if len(lstm_losses) != 3 or not all(np.isfinite(lstm_losses)):
            raise AssertionError(f"the LSTM's losses: {lstm_losses}")
        out["lstmLosses"] = lstm_losses
        # PATCH the step to the classifier's 512 ids; ctx.wait's own
        # latency after the flag flips, read by a poller of the catalog
        flipped = {}

        def watch_flag():
            while not (ctx.catalog.get_metadata("imdb_tokens") or {}).get(
                    "finished"):
                time.sleep(0.001)
            flipped["t"] = time.monotonic()

        client.function_python.update("imdb_tokens", {
            "functionParameters": {"rows": FN_IMDB_ROWS, "seq": CLF_SEQ,
                                   "seed": 1}})
        poller = threading.Thread(target=watch_flag, daemon=True)
        poller.start()
        t0 = time.monotonic()
        client.wait("imdb_tokens", timeout=600)
        returned = time.monotonic()
        poller.join(timeout=60)
        out["jobSeconds"]["imdb_tokens(PATCH)"] = returned - t0
        out["waitLatencyAfterFinishedMs"] = (returned - flipped["t"]) * 1e3
        tokens = ctx.artifacts.load("imdb_tokens", "function/python")
        tx, ty = tokens["x"], tokens["y"]
        if tx.shape != (FN_IMDB_ROWS, CLF_SEQ) or not 0 < tx.min() \
                or not tx.max() < 20000:
            raise AssertionError(f"imdb_tokens: {tx.shape} "
                                 f"[{tx.min()}, {tx.max()}]")
        clf_body = dict(CLF_CONFIG, attention="flash")
        fresh = TextClassifier(**clf_body, device="cuda")
        fresh.set_params(weights_lib.params_from_flax(
            weights_lib.init_params(CLF_CONFIG, fresh.seed)))
        untrained = fresh.evaluate(tx, ty, batch_size=CLF_BATCH)["loss"]
        del fresh
        direct = TextClassifier(**clf_body, device="cuda").fit(
            tx, ty, batch_size=CLF_BATCH, epochs=1).history["loss"]
        client.model_tensorflow.create("clf", models, "TextClassifier",
                                       clf_body)
        finished("clf", _observe_wait(client, "clf"))
        _reset_launches(attn)
        t0 = time.monotonic()
        execution(client.train_tensorflow, "clf_t", "clf", "fit",
                  {"x": "$imdb_tokens.x", "y": "$imdb_tokens.y",
                   "batch_size": "#2 ** 7", "epochs": 1})
        clf_train_s = time.monotonic() - t0
        execution(client.evaluate_tensorflow, "clf_e", "clf_t", "evaluate",
                  {"x": "$imdb_tokens.x", "y": "$imdb_tokens.y",
                   "batch_size": CLF_BATCH})
        launches = _launches(attn)
        steps = FN_IMDB_ROWS // CLF_BATCH
        layers = CLF_CONFIG["n_layers"]
        want_launches = dict.fromkeys(COUNTERS, 0)
        want_launches.update(flash_fwd_sm90=layers * 2 * steps,
                             flash_bwd_dq_sm90=layers * steps,
                             flash_bwd_dkv_sm90=layers * steps)
        if launches != want_launches:
            raise AssertionError(f"the classifier's REST fit and evaluate "
                                 f"launched {launches}, want "
                                 f"{want_launches}")
        clf_losses = epoch_losses(client.train_tensorflow, "clf_t")
        clf_eval = next(d["result"] for d in client.evaluate_tensorflow.read(
            "clf_e")["result"] if "result" in d)
        clf_rel = max(abs(a - b) / abs(b)
                      for a, b in zip(clf_losses, direct))
        if len(clf_losses) != 1 or not clf_rel <= 1e-5 or \
                not clf_eval["loss"] < untrained:
            raise AssertionError(f"the classifier: REST losses {clf_losses},"
                                 f" direct {direct}; evaluate {clf_eval}, "
                                 f"untrained {untrained}")
        out["classifier"] = {
            "config": clf_body, "rows": FN_IMDB_ROWS, "seq": CLF_SEQ,
            "batchSize": "#2 ** 7", "epochs": 1, "launches": launches,
            "losses": clf_losses, "directLosses": direct,
            "maxRelToDirect": clf_rel, "bitEqualToDirect": clf_losses == direct,
            "evaluate": clf_eval, "untrainedEvaluateLoss": untrained,
            "trainJobSeconds": clf_train_s}

        # (d) workflow 1, where the jailed child has sklearn and pandas
        if probe["sklearn"] and probe["pandas"]:
            titanic_csv = os.path.join(home, "titanic.csv")
            _fn_titanic(np, titanic_csv)
            client.dataset_csv.insert("titanic", titanic_csv)
            finished("titanic", _observe_wait(client, "titanic"))
            prep = function("titanic_prep", TITANIC_PREP,
                            {"df": "$titanic"})
            client.model_scikitlearn.create(
                "lr", "sklearn.linear_model", "LogisticRegression",
                {"max_iter": 500})
            finished("lr", _observe_wait(client, "lr"))
            execution(client.train_scikitlearn, "lr_t", "lr", "fit",
                      {"X": "$titanic_prep.x", "y": "$titanic_prep.y"})
            execution(client.evaluate_scikitlearn, "lr_e", "lr_t", "score",
                      {"X": "$titanic_prep.x", "y": "$titanic_prep.y"})
            score = next(d["result"] for d in client.evaluate_scikitlearn.read(
                "lr_e")["result"] if "result" in d)
            if not 0.5 < score <= 1.0:
                raise AssertionError(f"the LogisticRegression score {score}")
            out["sklearn"] = {"rows": int(len(prep["x"])), "score": score}
        else:
            out["sklearn"] = "absent"

        # (e) the child's spawn: an empty job's POST-to-finished
        function("empty", "response = 1\n", {})
        empty = out["jobSeconds"]["empty"]
        out["spawnShare"] = {name: empty / seconds
                             for name, seconds in out["jobSeconds"].items()}
    finally:
        server.stop()
    out["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("function " + json.dumps(out))
    return {"function": launches}


TRANSFORM_ROWS = 4096
# the boot-recovery server: `python -m learningorchestra_tpu_torch` run
# as by -m, which prints each kernel's launches when it exits
RECOVERY_SERVER = (
    "import atexit, json, runpy\n"
    "from learningorchestra_tpu_torch.ops import attention as attn\n"
    f"counters = {COUNTERS!r}\n"
    "atexit.register(lambda: print('launches ' + json.dumps(\n"
    "    {k: getattr(attn, v) for k, v in counters.items()}), flush=True))\n"
    "runpy.run_module('learningorchestra_tpu_torch', run_name='__main__',\n"
    "                 alter_sys=True)\n")


def _card_bytes(torch) -> int:
    """Card memory held by live tensors once the queued work ran, less
    cuBLAS's workspaces (one a thread's handle, kept by PyTorch: a job
    on a pool thread that never used cuBLAS would add one)."""
    gc.collect()
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def _save_arrays(ctx, name: str, arrays: dict) -> None:
    """Arrays as a finished function artifact: ``$name.key`` feeds them
    to a job, as a Function step's ``response`` would."""
    ctx.catalog.create_collection(name, "function/python", {})
    ctx.artifacts.save(arrays, name, "function/python")
    ctx.catalog.mark_finished(name)


def transform_phase(torch, log, home, yard):
    """BASELINE config 3 over HTTP through the port's client (the
    ``transform`` line): IMDb-shaped rows as a CSV whose 200 id columns
    are written as integral floats (``12.0``) beside a text column, then
    ``transform/dataType`` to number (the ids must come back as the ints
    written), ``transform/projection`` to the ids and to the label (rows
    equal to the CSV's), ``explore/histogram`` of the label (counts equal
    to numpy's), the tutorial LSTM's ``/train`` on ``$ids``/``$lab`` (1
    epoch, batch 128; losses within 1e-5 relative of a direct fit on the
    same arrays) and ``/evaluate``; an explore plot (a PNG, or an
    ``ImportError`` job where the card's machine has no matplotlib); the
    GET cache's hits on the polls. Returns the path's kernel launches
    (none: the LSTM runs on cuDNN)."""
    import numpy as np

    from learningorchestra_tpu_torch import client as lo_client
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models.neural import NeuralModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    phase_t0 = time.monotonic()
    ix, iy = _imdb_like(np, TRANSFORM_ROWS, seed=3)
    ids = [f"t{i}" for i in range(IMDB_SEQ)]
    csv_path = os.path.join(home, "imdb.csv")
    with open(csv_path, "w") as f:
        f.write(",".join(ids + ["review", "label"]) + "\n")
        for i, (row, label) in enumerate(zip(ix.tolist(), iy.tolist())):
            f.write(",".join(f"{t}.0" for t in row) + f",r{i},{label}\n")
    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    client = lo_client.Context(server.base_url)
    base = server.base_url
    out: dict = {"rows": TRANSFORM_ROWS, "idColumns": IMDB_SEQ}
    _reset_launches(attn)

    def done(name):
        meta = _observe_wait(client, name)
        if not meta.get("finished"):
            raise AssertionError(f"job {name}: {meta.get('failedDocument')}")
        return meta

    def columns(name):
        cols = ctx.catalog.read_columns(name)
        return {k: (kind, data) for k, (kind, data, _) in cols.items()}

    try:
        t0 = time.monotonic()
        client.dataset_csv.insert("imdb", csv_path)
        done("imdb")
        out["ingestSeconds"] = time.monotonic() - t0
        kinds = {kind for k, (kind, _) in columns("imdb").items()
                 if k in ids}
        if kinds != {"float64"}:
            raise AssertionError(f"the id columns ingested as {kinds}")
        t0 = time.monotonic()
        client.transform_datatype.run_datatype(
            "imdb", dict.fromkeys(ids, "number"))
        _poll(base, "/dataset/csv/imdb")
        out["dataTypeSeconds"] = time.monotonic() - t0
        cast = columns("imdb")
        if {cast[k][0] for k in ids} != {"int64"} or not np.array_equal(
                np.stack([cast[k][1] for k in ids], 1), ix):
            raise AssertionError("dataType did not give the ints written")
        first = client.dataset_csv.read("imdb", skip=1, limit=1)["result"][0]
        if [first[k] for k in ids] != ix[0].tolist() or \
                not all(type(first[k]) is int for k in ids):
            raise AssertionError(f"the first row reads {first}")

        t0 = time.monotonic()
        for name, names in (("ids", ids), ("lab", ["label"])):
            client.transform_projection.run_projection("imdb", name, names)
            _poll(base, f"/transform/projection/{name}")
        out["projectionSeconds"] = time.monotonic() - t0
        proj, lab = columns("ids"), columns("lab")
        if list(proj) != ids or not np.array_equal(
                np.stack([proj[k][1] for k in ids], 1), ix) or \
                not np.array_equal(lab["label"][1], iy):
            raise AssertionError("the projections differ from the CSV")

        client.explore_histogram.run_histogram("imdb", "lab_hist",
                                               ["label"])
        done("lab_hist")
        buckets = [d for d in client.explore_histogram.read("lab_hist")[
            "result"] if "label" in d][0]["label"]
        values, counts = np.unique(iy, return_counts=True)
        if sorted((b["_id"], b["count"]) for b in buckets) != \
                list(zip(values.tolist(), counts.tolist())):
            raise AssertionError(f"histogram {buckets}")
        out["histogram"] = buckets

        # the tutorial LSTM over REST and directly on the same arrays
        direct = NeuralModel(TUTORIAL_LSTM, device="cuda")
        want = direct.fit(ix, iy, batch_size=IMDB_BATCH,
                          epochs=1).history["loss"]
        want_ev = direct.evaluate(ix, iy, batch_size=IMDB_BATCH)
        del direct
        client.model_tensorflow.create(
            "lstm", "learningorchestra_tpu.models", "NeuralModel",
            {"layer_configs": TUTORIAL_LSTM})
        _poll(base, "/model/tensorflow/lstm")
        t0 = time.monotonic()
        client.train_tensorflow.run("lstm_t", "lstm", "fit", {
            "x": "$ids", "y": "$lab", "epochs": 1,
            "batch_size": IMDB_BATCH})
        _poll(base, "/train/tensorflow/lstm_t")
        out["trainJobSeconds"] = time.monotonic() - t0
        got = [d["epochRecord"]["loss"] for d in client.train_tensorflow.read(
            "lstm_t")["result"] if "epochRecord" in d]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if len(got) != 1 or not np.isfinite(got[0]) or rel > 1e-5:
            raise AssertionError(f"REST LSTM losses {got}, direct {want}")
        client.evaluate_tensorflow.run("lstm_ev", "lstm_t", "evaluate", {
            "x": "$ids", "y": "$lab", "batch_size": IMDB_BATCH})
        _poll(base, "/evaluate/tensorflow/lstm_ev")
        ev = next(d["result"] for d in client.evaluate_tensorflow.read(
            "lstm_ev")["result"] if "result" in d)
        ev_rel = max(abs(ev[k] - want_ev[k]) / max(abs(want_ev[k]), 1e-12)
                     for k in want_ev)
        if ev_rel > 1e-5:
            raise AssertionError(f"REST evaluate {ev}, direct {want_ev}")
        out.update(losses=got, directLosses=want, bitEqualToDirect=got ==
                   want, maxRelToDirect=rel, evaluate=ev,
                   evaluateMaxRelToDirect=ev_rel)

        # an explore plot: a PNG where matplotlib and seaborn import
        client.explore_tensorflow.run_class(
            "plot", "numpy", "arange", {"start": 0, "stop": 64})
        meta = _observe_wait(client, "plot")
        if meta.get("finished"):
            png = client.explore_tensorflow.read_image("plot")
            if png[:8] != b"\x89PNG\r\n\x1a\n":
                raise AssertionError("the explore plot is not a PNG")
            out["explorePlot"] = {"png": True, "bytes": len(png)}
        else:
            error = meta["failedDocument"]["exception"]
            if not error.startswith("ImportError(") or \
                    "an explore plot needs matplotlib and seaborn" \
                    not in error:
                raise AssertionError(f"the explore job failed: {error}")
            out["explorePlot"] = {"png": False, "importError": error}
        # a finished result read twice, as a client re-reads it
        for _ in range(2):
            client.explore_histogram.read("lab_hist", limit=1)
        out["getCache"] = server.api.read_cache.stats()
        if not out["getCache"]["hits"] > 0:
            raise AssertionError(f"no GET cache hit: {out['getCache']}")
    finally:
        server.stop()
    launches = _launches(attn)
    if any(launches.values()):
        raise AssertionError(f"the transform path launched {launches}")
    out["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("transform " + json.dumps(out))
    return {"transform": launches}


# the Builder's pipeline (the ``builder`` line)
# (a) the tutorial's section 6: tests/test_server.py's modelingCode
BUILDER_MODELING = (
    "import numpy as np\n"
    "def feats(df):\n"
    "    return np.stack([df['pclass'].to_numpy(float),"
    " (df['sex']=='female').to_numpy(float)], axis=1)\n"
    "features_training = (feats(training_df),"
    " training_df['survived'].to_numpy('int64'))\n"
    "features_evaluation = features_training\n"
    "features_testing = feats(testing_df)\n")
# (b) LR and NB on the card at a million rows of 16 float32 features and
# 4 classes; the modeling code works on a DataFrame and on a Table
WIDE_ROWS, WIDE_TEST_ROWS, WIDE_FEATURES, WIDE_CLASSES = \
    1_000_000, 100_000, 16, 4
# the builder phase's (b) card-against-CPU LR and NB: the first 125,000
# of those rows (the checks compare two fits of the same rows)
BUILDER_WIDE_ROWS = 125_000
WIDE_MODELING = (
    "import numpy as np\n"
    f"feats = ['f%d' % i for i in range({WIDE_FEATURES})]\n"
    "def xs(df):\n"
    "    return np.stack([np.asarray(df[c], dtype=np.float32)"
    " for c in feats], axis=1)\n"
    "features_training = (xs(training_df),"
    " np.asarray(training_df['label']))\n"
    "features_testing = xs(testing_df)\n"
    "features_evaluation = (features_testing,"
    " np.asarray(testing_df['label']))\n")
# the card's LR against the CPU's: w and b centred over the classes (a
# constant added to every logit changes nothing, so no gradient fixes
# that direction and bfloat16 rounding lets it drift), within this share
# of the largest |w|; NB's statistics within this relative difference
WIDE_LR_TOL, WIDE_NB_TOL = 1e-2, 1e-5
# (c) BASELINE config 4: GB over 10M rows x 5 features, streamed; the
# label is the sign of the CPU tests' linear margin (a fifth weight added)
BASELINE4_ROWS, BASELINE4_SIDE_ROWS, BASELINE4_CHUNK = \
    10_000_000, 100_000, 1_000_000
BASELINE4_WEIGHTS = (1.0, -2.0, 0.5, 1.5, 0.7)
BASELINE4_MIN_ACCURACY = 0.95
BASELINE4_PEAK_BYTES = 1 << 30
# (f) the streaming families over the first rows of config 4's generator
# (the seeds of the ingest phase's CSVs), the test and evaluation sets at
# config 4's side size
STREAM_FAMILIES = ["LR", "NB", "DT", "RF"]
STREAM_ROWS, STREAM_MIN_ACCURACY = 50_000, 0.9
# the tree and SGD cores' counters (native/trees.py, native/sgd.py)
HOST_CORE_OPS = ("tree_fit", "tree_predict", "gb_residuals",
                 "sgd_partial_fit")
# (d) a NeuralModel stack whose declared input a conv2d cannot take
PREFLIGHT_BAD = [{"kind": "input", "shape": [8]},
                 {"kind": "conv2d", "filters": 4, "kernel": 3}]
PREFLIGHT_GOOD = [{"kind": "input", "shape": [8]},
                  {"kind": "dense", "units": 16, "activation": "relu"},
                  {"kind": "dense", "units": 2, "activation": "softmax"}]
PREFLIGHT_DATA = (
    "import numpy as np\n"
    "rng = np.random.default_rng(0)\n"
    "x = rng.normal(size=(256, 8)).astype(np.float32)\n"
    "y = (x[:, 0] > 0).astype(np.int32)\n"
    "response = {'x': x, 'y': y}\n")


def _builder_titanic(np, path) -> None:
    """tests/test_server.py's Titanic-shaped generator at the published
    891 rows: pid, survived, pclass, sex, age, fare."""
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        f.write("pid,survived,pclass,sex,age,fare\n")
        for i in range(TITANIC_ROWS):
            pclass = int(rng.integers(1, 4))
            sex = str(rng.choice(["male", "female"]))
            age = round(float(rng.uniform(1, 70)), 1)
            fare = round(float(rng.uniform(5, 200)), 2)
            survived = int(rng.random() < (0.8 if sex == "female" else 0.2))
            f.write(f"{i},{survived},{pclass},{sex},{age},{fare}\n")


def _write_dataset(ctx, name: str, chunks) -> None:
    """Column chunks (``{column: array}``) through the catalog writer, as
    a finished dataset."""
    ctx.catalog.create_collection(name, "dataset/csv", {})
    with ctx.catalog.dataset_writer(name) as w:
        for columns in chunks:
            w.write_batch(columns)
    ctx.catalog.mark_finished(name)


def _wide_data(np, rows: int, seed: int):
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(99).normal(
        size=(WIDE_FEATURES, WIDE_CLASSES)).astype(np.float32)
    x = rng.normal(size=(rows, WIDE_FEATURES)).astype(np.float32) + \
        np.float32(0.5)
    noise = rng.normal(size=(rows, WIDE_CLASSES)).astype(np.float32)
    return x, np.argmax(x @ w + noise, axis=1).astype(np.int64)


def _baseline4_chunks(np, rows: int, seed: int):
    rng = np.random.default_rng(seed)
    w = np.asarray(BASELINE4_WEIGHTS)
    for start in range(0, rows, BASELINE4_CHUNK):
        x = rng.normal(size=(min(BASELINE4_CHUNK, rows - start), len(w)))
        columns = {f"f{i}": x[:, i] for i in range(len(w))}
        columns["label"] = (x @ w > 0).astype(np.int64)
        yield columns


def _titanic_features(np, path):
    """The tutorial's modelingCode on the CSV at ``path``: (``pclass``,
    ``sex == female``) and ``survived``."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    x = np.array([[float(r["pclass"]), float(r["sex"] == "female")]
                  for r in rows])
    return x, np.array([int(r["survived"]) for r in rows])


def _plain_path(fn):
    """``fn()`` on the native cores' plain Python versions
    (``LO_NATIVE=0``, read at every call)."""
    saved = os.environ.get("LO_NATIVE")
    os.environ["LO_NATIVE"] = "0"
    try:
        return fn()
    finally:
        if saved is None:
            os.environ.pop("LO_NATIVE", None)
        else:
            os.environ["LO_NATIVE"] = saved


def _centred(params):
    w, b = params["w"], params["b"]
    return w - w.mean(axis=1, keepdims=True), b - b.mean()


def builder_phase(torch, log, home, yard):
    """The Builder over HTTP through the port's client (the ``builder``
    line). (a) The tutorial's section 6: a Titanic-shaped CSV, the
    modelingCode of tests/test_server.py, LR/NB/DT/RF/GB with
    ``meshParallel``: LR and NB fitted on the card (torch estimators on
    CUDA, the job under the card lease, card memory rising during the
    fit and back within 1 MiB after), DT/RF/GB on the host, accuracy
    above 0.6. (a') The same body without ``meshParallel``: all five on
    the host; the trees' predictions in both bodies equal their plain
    Python versions'. (b) LR and NB at 125,000 rows of 16 features and 4
    classes on the card against the port's CPU fit of the same rows.
    (BASELINE config 4, formerly (c), is the ``ingest`` phase's.) (d) The
    model preflight: a stack that cannot build on its declared input is a
    406 with ``shape-mismatch``, a good one a 201 whose ``/train`` job
    carries the heuristic ``footprint``. (e) No flash kernel launches.
    (f) The streaming LR, NB, DT and RF over config 4's first 50,000 rows.
    The host families run the tree and SGD cores' native paths only, and
    no sklearn module loads. Returns the path's kernel launches (none)."""
    import numpy as np

    from learningorchestra_tpu_torch import client as lo_client
    from learningorchestra_tpu_torch import native
    from learningorchestra_tpu_torch.models import linear as host_linear
    from learningorchestra_tpu_torch.models import trees as host_trees
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models.estimators import (
        GaussianNBJAX, LogisticRegressionJAX)
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime import arena as arena_lib
    from learningorchestra_tpu_torch.services import builder_service
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    phase_t0 = time.monotonic()
    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    client = lo_client.Context(server.base_url)
    base = server.base_url
    out: dict = {}
    # the estimators the jobs build
    made = []
    make_torch = builder_service._make_torch_classifier

    def recorded_make(name, device):
        made.append(make_torch(name, device))
        return made[-1]

    builder_service._make_torch_classifier = recorded_make
    _reset_launches(attn)
    native.reset_counts()

    def run(train, test, code, classifiers, **extra):
        t0 = time.monotonic()
        uris = client.builder_sparkml.run_builder(train, test, code,
                                                  classifiers, **extra)
        names = [u.rsplit("/", 1)[1] for u in uris]
        ctx.jobs.wait(names[0], timeout=900)
        seconds = time.monotonic() - t0
        metas = {c: client.builder_sparkml.metadata(n)
                 for c, n in zip(classifiers, names)}
        return names, metas, seconds

    def failure(name):
        docs = client.builder_sparkml.read(name)["result"]
        return next(d["exception"] for d in docs if d.get("exception"))

    try:
        # (a) the tutorial's section 6
        csv_path = os.path.join(home, "titanic.csv")
        _builder_titanic(np, csv_path)
        client.dataset_csv.insert("titanic", csv_path)
        _observe_wait(client, "titanic")
        before = _card_bytes(torch)
        torch.cuda.reset_peak_memory_stats()
        families = ["LR", "NB", "DT", "RF", "GB"]
        names, metas, seconds = run(
            "titanic", "titanic", BUILDER_MODELING, families,
            meshParallel=True, evaluationDatasetName="titanic")
        peak = torch.cuda.max_memory_allocated()
        # the card families' staged tensors stay in the device arena for
        # a repeat job: card bytes less the arena's, then after a clear
        arena = arena_lib.get_default_arena()
        resident = arena.stats()["bytesInUse"]
        after = _card_bytes(torch)
        arena.clear()
        cleared = _card_bytes(torch)
        tutorial = {"jobSeconds": seconds, "cardBytesBefore": before,
                    "cardBytesAfter": after, "arenaBytesInUse": resident,
                    "cardBytesAfterArenaClear": cleared,
                    "cardPeakBytes": peak}
        for c in ("LR", "NB"):
            meta = metas[c]
            if not meta.get("finished") or meta.get("engine") != "torch" \
                    or meta.get("meshDevices") != 1 \
                    or not meta.get("accuracy", 0) > 0.6:
                raise AssertionError(f"tutorial {c}: {meta}")
            tutorial[c] = {k: meta[k] for k in ("accuracy", "f1",
                                                "fitTime")}
        devices = sorted({clf.device.type for clf in made})
        if len(made) != 2 or devices != ["cuda"]:
            raise AssertionError(f"the torch families ran on {devices}")
        if "leaseWaitSeconds" not in metas["LR"] or not peak > before:
            raise AssertionError(f"no card lease or no card memory: "
                                 f"{metas['LR']}, peak {peak}")
        if abs(after - resident - before) > (1 << 20) or \
                abs(cleared - before) > (1 << 20):
            raise AssertionError(f"card memory {before} -> {after} (arena "
                                 f"{resident}), {cleared} after a clear")
        def host_finished(metas, names, classifiers):
            """Each host family finished (``engine: "host"``, accuracy
            above 0.6) with a prediction for every row; its predictions
            and metrics."""
            got = {}
            for c, name in zip(families, names):
                meta = metas[c]
                if c not in classifiers:
                    continue
                if not meta.get("finished"):
                    raise AssertionError(f"{name}: {failure(name)}")
                if meta.get("engine") != "host" or \
                        not meta.get("accuracy", 0) > 0.6:
                    raise AssertionError(f"{name}: {meta}")
                predicted = ctx.catalog.read_columns(name)["prediction"][1]
                if len(predicted) != TITANIC_ROWS:
                    raise AssertionError(f"{name}: {len(predicted)} "
                                         f"predictions")
                got[c] = (np.asarray(predicted), {
                    k: meta[k] for k in ("accuracy", "f1", "fitTime")})
            return got

        tree_families = ("DT", "RF", "GB")
        mesh_trees = host_finished(metas, names, tree_families)
        tutorial["hostFamilies"] = {c: m for c, (_, m) in
                                    mesh_trees.items()}
        rows = client.builder_sparkml.read(names[0], skip=1, limit=3)
        if not all("prediction" in r for r in rows["result"]):
            raise AssertionError(f"tutorial predictions {rows}")
        out["tutorial"] = tutorial

        # (a') the reference's own body: no meshParallel, all five host
        client.dataset_csv.insert("titanicRef", csv_path)
        _observe_wait(client, "titanicRef")
        names, metas, seconds = run(
            "titanic", "titanicRef", BUILDER_MODELING, families,
            evaluationDatasetName="titanic")
        reference = host_finished(metas, names, families)
        out["referenceBody"] = {"jobSeconds": seconds, **{
            c: m for c, (_, m) in reference.items()}}

        # (b) LR and NB on wide rows, the card against the CPU
        t0 = time.monotonic()
        x, y = _wide_data(np, BUILDER_WIDE_ROWS, seed=11)
        xt, yt = _wide_data(np, WIDE_TEST_ROWS, seed=12)
        for name, (xs, ys) in (("wide", (x, y)), ("wideTest", (xt, yt))):
            columns = {f"f{i}": xs[:, i] for i in range(WIDE_FEATURES)}
            columns["label"] = ys
            _write_dataset(ctx, name, [columns])
        made.clear()
        names, metas, seconds = run(
            "wide", "wideTest", WIDE_MODELING, ["LR", "NB"],
            meshParallel=True, evaluationDatasetName="wideTest")
        if not all(m.get("finished") and m.get("engine") == "torch"
                   for m in metas.values()):
            raise AssertionError(f"wide fits {metas}")
        card = {type(clf).__name__: clf for clf in made}
        wide = {"rows": BUILDER_WIDE_ROWS, "writeAndJobSeconds":
                time.monotonic() - t0, "jobSeconds": seconds}
        predictions = {c: ctx.catalog.read_columns(n)["prediction"][1]
                       for c, n in zip(("LR", "NB"), names)}
        t1 = time.monotonic()
        cpu_lr = LogisticRegressionJAX(device="cpu").fit(x, y)
        lr_cpu_seconds = time.monotonic() - t1
        (cw, cb), (gw, gb) = _centred(cpu_lr.params), \
            _centred(card["LogisticRegressionJAX"].params)
        scale = float(np.abs(cpu_lr.params["w"]).max())
        lr_diff = max(float(np.abs(cw - gw).max()),
                      float(np.abs(cb - gb).max())) / scale
        lr_agree = float(np.mean(predictions["LR"] == cpu_lr.predict(xt)))
        t1 = time.monotonic()
        cpu_nb = GaussianNBJAX(device="cpu").fit(x, y)
        nb_cpu_seconds = time.monotonic() - t1
        card_nb = card["GaussianNBJAX"]
        nb_diff = {k: float(np.abs(getattr(card_nb, k) - getattr(
            cpu_nb, k)).max() / np.abs(getattr(cpu_nb, k)).max())
            for k in ("theta_", "var_")}
        nb_equal = bool(np.array_equal(predictions["NB"],
                                       cpu_nb.predict(xt)))
        wide.update(
            lr={"cardFitSeconds": metas["LR"]["fitTime"],
                "cpuFitSeconds": lr_cpu_seconds,
                "centredMaxDiffOverMaxW": lr_diff,
                "predictionsEqualShare": lr_agree,
                "accuracy": metas["LR"]["accuracy"]},
            nb={"cardFitSeconds": metas["NB"]["fitTime"],
                "cpuFitSeconds": nb_cpu_seconds, "maxRelDiff": nb_diff,
                "predictionsEqual": nb_equal,
                "accuracy": metas["NB"]["accuracy"]})
        out["wide"] = wide
        if lr_diff > WIDE_LR_TOL or lr_agree < 0.995:
            raise AssertionError(f"card LR vs CPU: {wide['lr']}")
        if max(nb_diff.values()) > WIDE_NB_TOL or not nb_equal:
            raise AssertionError(f"card NB vs CPU: {wide['nb']}")
        del x, y, xt, yt, cpu_lr, cpu_nb, card, card_nb, predictions

        # (d) the model preflight over HTTP
        bad = {"modelName": "pf_bad",
               "modulePath": "learningorchestra_tpu.models",
               "class": "NeuralModel",
               "classParameters": {"layer_configs": PREFLIGHT_BAD}}
        status, body = _http(base, "POST", "/model/tensorflow", bad)
        rules = [f["rule"] for f in body.get("analysis", [])]
        if status != 406 or "shape-mismatch" not in rules or \
                _http(base, "GET", "/model/tensorflow/pf_bad")[0] != 404:
            raise AssertionError(f"bad stack: {status} {body}")
        status, body = _http(base, "POST", "/model/tensorflow", dict(
            bad, modelName="pf_good",
            classParameters={"layer_configs": PREFLIGHT_GOOD}))
        if status != 201:
            raise AssertionError(f"good stack: {status} {body}")
        client.function_python.run_function("pf_data", PREFLIGHT_DATA)
        _observe_wait(client, "pf_data")
        _poll(base, "/model/tensorflow/pf_good")
        client.train_tensorflow.run("pf_fit", "pf_good", "fit", {
            "x": "$pf_data.x", "y": "$pf_data.y", "epochs": 1,
            "batch_size": 32})
        footprint = client.train_tensorflow.metadata("pf_fit").get(
            "footprint") or {}
        _poll(base, "/train/tensorflow/pf_fit")
        # dense 8x16 + 16 and 16x2 + 2, float32
        want_params = (8 * 16 + 16 + 16 * 2 + 2) * 4
        if footprint.get("estimator") != "heuristic" or \
                footprint.get("paramBytes") != want_params:
            raise AssertionError(f"footprint {footprint}")
        out["preflight"] = {"badStatus": 406, "rules": rules,
                            "footprint": footprint}

        # (f) the streaming families over config 4's first rows
        t0 = time.monotonic()
        for name, rows, seed in (("b4sTrain", STREAM_ROWS, 21),
                                 ("b4sTest", BASELINE4_SIDE_ROWS, 22),
                                 ("b4sEval", BASELINE4_SIDE_ROWS, 23)):
            _write_dataset(ctx, name, _baseline4_chunks(np, rows, seed))
        write_seconds = time.monotonic() - t0
        t0 = time.monotonic()
        uris = client.builder_sparkml.run_builder(
            "b4sTrain", "b4sTest", "", STREAM_FAMILIES, streaming=True,
            evaluationDatasetName="b4sEval")
        stream_names = [u.rsplit("/", 1)[1] for u in uris]
        ctx.jobs.wait(stream_names[0], timeout=900)
        streaming = {"rows": STREAM_ROWS, "writeSeconds": write_seconds,
                     "jobSeconds": time.monotonic() - t0}
        for c, name in zip(STREAM_FAMILIES, stream_names):
            meta = client.builder_sparkml.metadata(name)
            streaming[c] = {k: meta.get(k) for k in (
                "fitTime", "accuracy", "f1", "trainedOnSample")}
            if not meta.get("finished") or meta.get("streaming") is not \
                    True or meta.get("trainedOnSample") is not False or \
                    not meta.get("accuracy", 0) > STREAM_MIN_ACCURACY:
                raise AssertionError(f"streaming {c}: {meta}")
        out["streaming"] = streaming

        # every host family above ran the cores' native paths only
        counts = native.counts()
        host_cores = {op: counts.get(op, {}) for op in HOST_CORE_OPS}
        out["hostCores"] = host_cores
        if any(not paths.get("native", {}).get("calls") or
               "python" in paths for paths in host_cores.values()):
            raise AssertionError(f"the host cores' paths: {host_cores}")

        # the plain Python versions on the same rows and seeds
        x, y = _titanic_features(np, csv_path)
        t0 = time.monotonic()
        plain = _plain_path(lambda: {
            c: make().fit(x, y).predict(x) for c, make in (
                ("DT", host_trees.DecisionTreeClassifier),
                ("RF", host_trees.RandomForestClassifier),
                ("GB", host_trees.GradientBoostingClassifier))})
        plain_equal = {c: bool(np.array_equal(plain[c], reference[c][0])
                               and np.array_equal(plain[c],
                                                  mesh_trees[c][0]))
                       for c in plain}
        train = next(_baseline4_chunks(np, STREAM_ROWS, 21))
        test = next(_baseline4_chunks(np, BASELINE4_SIDE_ROWS, 22))
        feats = [f"f{i}" for i in range(len(BASELINE4_WEIGHTS))]

        def plain_sgd():
            clf = host_linear.SGDClassifier().partial_fit(
                np.column_stack([train[f] for f in feats]), train["label"],
                classes=np.array([0, 1]))
            return clf.predict(np.column_stack([test[f] for f in feats]))

        sgd_plain = _plain_path(plain_sgd)
        lr_job = ctx.catalog.read_columns(
            stream_names[STREAM_FAMILIES.index("LR")])["prediction"][1]
        plain_equal["streamingLR"] = bool(np.array_equal(
            sgd_plain, np.asarray(lr_job)))
        out["plainEqual"] = plain_equal
        out["plainSeconds"] = time.monotonic() - t0
        if not all(plain_equal.values()):
            raise AssertionError(f"the native cores against their plain "
                                 f"versions: {plain_equal}")
        sklearn_modules = sorted(m for m in sys.modules
                                 if m.split(".")[0] == "sklearn")
        out["sklearnModules"] = sklearn_modules
        if sklearn_modules:
            raise AssertionError(f"sklearn loaded: {sklearn_modules}")
    finally:
        builder_service._make_torch_classifier = make_torch
        server.stop()
    # (e) nothing on this path launches a flash kernel
    launches = _launches(attn)
    if any(launches.values()):
        raise AssertionError(f"the builder path launched {launches}")
    out["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("builder " + json.dumps(out))
    return {"builder": launches}

# BASELINE config 4 as CSV files (the ingest phase): the features of
# _baseline4_chunks rounded to INGEST_DECIMALS and written as fixed-point
# text, the label the sign of the margin of the rounded features
INGEST_DECIMALS = 6
INGEST_HEAD_ROWS = 200_000
INGEST_QUERY = {"f0": {"$gt": 4.2}}
INGEST_QUERY_SKIP, INGEST_QUERY_LIMIT = 5, 20
INGEST_RSS_BYTES = 1 << 30
# (b)'s streaming GB trains on the first 500,000 ingested rows (the
# whole script's time limit; the 10M rows stay for (a), (c) and (d))
INGEST_GB_ROWS = 500_000
# (e) a batch of 256 rows of ResNet-50's input width (224 x 224 x 3
# float32) gathered from 1024
GATHER_ROWS, GATHER_WIDTH, GATHER_BATCH = 1024, 224 * 224 * 3, 256


def _fixed_point_rows(np, k, label) -> "np.ndarray":
    """CSV text of rows ``k / 10**INGEST_DECIMALS`` (an int64 matrix,
    each |value| < 10) as ``-d.dddddd`` fields and an int label: a
    fixed-width byte matrix with a sign slot a field, filled digit by
    digit, then the slots of the non-negative values dropped."""
    n, m = k.shape
    a = np.abs(k)
    if a.max(initial=0) >= 10 ** (INGEST_DECIMALS + 1):
        raise AssertionError("a feature of 10 or more")
    a = np.ascontiguousarray(a.T, np.uint32)
    # sign, units, point, the decimals, comma; filled a column at a time
    # (rows of the transposed matrix), then laid out row by row
    field = 4 + INGEST_DECIMALS
    text = np.empty((field * m + 2, n), np.uint8)
    keep = np.ones(text.shape, bool)
    for j in range(m):
        o = j * field
        text[o] = ord("-")
        keep[o] = k[:, j] < 0
        rest = a[j]
        for d in range(INGEST_DECIMALS, 0, -1):
            rest, digit = np.divmod(rest, 10)
            text[o + 2 + d] = digit
        text[o + 1] = rest
        text[o + 1:o + 3 + INGEST_DECIMALS] += ord("0")
        text[o + 2] = ord(".")
        text[o + 3 + INGEST_DECIMALS] = ord(",")
    text[-2] = label + ord("0")
    text[-1] = ord("\n")
    return text.T[keep.T]


def _baseline4_rounded(np, rows: int, seed: int):
    """``_baseline4_chunks``' features rounded to INGEST_DECIMALS, as
    ``(k, label)``: the int64 numerators and the label of the rounded
    margin, a chunk at a time."""
    w = np.asarray(BASELINE4_WEIGHTS)
    for columns in _baseline4_chunks(np, rows, seed):
        x = np.stack([columns[f"f{i}"] for i in range(len(w))], 1)
        k = np.rint(x * 10 ** INGEST_DECIMALS).astype(np.int64)
        yield k, (k / 10 ** INGEST_DECIMALS @ w > 0).astype(np.int64)


def _write_baseline4_csv(np, path: str, rows: int, seed: int) -> dict:
    """Config 4's rows as a CSV file: its bytes, the label counts, the
    rows that match INGEST_QUERY (``{row: (k, label)}``) and the chunks
    written (``[(k, label)]``)."""
    labels = np.zeros(2, np.int64)
    matches, start, written = {}, 0, []
    column, bound = next(iter(INGEST_QUERY.items()))
    with open(path, "wb") as f:
        f.write(b"f0,f1,f2,f3,f4,label\n")
        for k, label in _baseline4_rounded(np, rows, seed):
            written.append((k, label))
            _fixed_point_rows(np, k, label).tofile(f)
            labels += np.bincount(label, minlength=2)
            hit = np.flatnonzero(k[:, int(column[1:])] / 10 **
                                 INGEST_DECIMALS > bound["$gt"])
            matches.update({start + int(i): (k[i], int(label[i]))
                            for i in hit})
            start += len(k)
    return {"bytes": os.path.getsize(path), "labels": labels,
            "matches": matches, "written": written}


class _RssPeak:
    """The resident set's peak growth over a ``with`` block, from
    ``/proc/self/statm`` sampled on a thread every 2 ms."""

    def __enter__(self):
        self._page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _sample(self) -> None:
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())
        self.growth = self.peak - self.start


def _stored(ctx, name: str) -> dict:
    """``{column: (kind, memory-mapped data, null mask)}`` of a dataset."""
    return {col: (kind, data, mask) for col, kind, data, mask
            in ctx.catalog._generation(name)[1]}


def ingest_phase(torch, log, home, yard):
    """BASELINE config 4 ingested as a real CSV over REST (the ``ingest``
    line). (a) ``b4train`` (10,000,000 rows), ``b4test`` and ``b4eval``
    (100,000 each) written as CSV files (``_baseline4_chunks``' features,
    seeds 21/22/23, rounded to six decimals as fixed-point text; the label
    the sign of the rounded margin) and ``POST /dataset/csv``: every row
    through the port's C++ core (its build error None, no row on the
    Python path), five float64 columns and an int64 label, every stored
    value bit-equal to ``k / 1e6`` and the labels written; seconds, rows/s
    and MB/s of the big one, and the peak growth of resident memory over
    it under 1 GiB. (b) Streaming GB on the first ``INGEST_GB_ROWS``
    ingested rows (a dataset of them), ``b4test`` and ``b4eval``: every
    row trained through the built C++ booster, accuracy above 0.95, the
    job's ``tracemalloc`` peak under 1 GiB. (c) The first 200,000 rows through the core and
    through the Python path (``LO_NATIVE=0``): equal stored columns, µs a
    row each; a rare-match query GET over ``b4train`` equal to numpy's
    page of the written values, its seconds, and the per-row path's on
    the head. (d) The histogram of ``label`` over 10M rows equal to
    ``numpy.unique``'s counts; its seconds, and both paths' on the head.
    (e) ``gather_rows`` bit-equal to fancy indexing on a float32 matrix
    of ResNet-50's input width. Returns the path's kernel launches
    (none)."""
    import tracemalloc
    import urllib.parse

    import numpy as np

    from learningorchestra_tpu_torch import client as lo_client
    from learningorchestra_tpu_torch import native
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.native import hgb, ops
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    phase_t0 = time.monotonic()
    for core in (native.HGB, native.CSV):
        if native.get_lib(core) is None or native.build_error(core):
            raise AssertionError(f"the {core} core did not build: "
                                 f"{native.build_error(core)}")
    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    client = lo_client.Context(server.base_url)
    base = server.base_url
    out: dict = {}
    native_fits = []
    fit_binned = hgb.HistGB.fit_binned

    def recorded_fit(self, codes, y):
        result = fit_binned(self, codes, y)
        native_fits.append(self._model is not None)
        return result

    hgb.HistGB.fit_binned = recorded_fit
    _reset_launches(attn)

    def ingest(name, path):
        t0 = time.monotonic()
        client.dataset_csv.insert(name, path)
        ctx.jobs.wait(name, timeout=900)
        seconds = time.monotonic() - t0
        meta = client.dataset_csv.metadata(name)
        if not meta.get("finished"):
            raise AssertionError(f"ingest {name}: {meta}, "
                                 f"{client.dataset_csv.read(name)}")
        return meta, seconds

    def check_stored(name, rows, written):
        stored = _stored(ctx, name)
        kinds = [stored[c][0] for c in stored]
        if list(stored) != ["f0", "f1", "f2", "f3", "f4", "label"] or \
                kinds != ["float64"] * 5 + ["int64"] or \
                any(m is not None for _, _, m in stored.values()):
            raise AssertionError(f"{name}: columns {list(stored)}, kinds "
                                 f"{kinds}")
        start = 0
        for k, label in written:
            stop = start + len(k)
            want = k / 10 ** INGEST_DECIMALS
            for j in range(5):
                got = np.asarray(stored[f"f{j}"][1][start:stop])
                if not np.array_equal(got.view(np.int64),
                                      want[:, j].view(np.int64)):
                    raise AssertionError(f"{name}.f{j} rows {start}.."
                                         f"{stop} differ from k / 1e6")
            if not np.array_equal(stored["label"][1][start:stop], label):
                raise AssertionError(f"{name}.label rows {start}..{stop}")
            start = stop
        if start != rows:
            raise AssertionError(f"{name}: {start} rows checked")

    def page(name, query, skip, limit):
        params = urllib.parse.urlencode({"query": json.dumps(query),
                                         "skip": skip, "limit": limit})
        t0 = time.monotonic()
        status, body = _http(base, "GET", f"/dataset/csv/{name}?{params}")
        return status, body, time.monotonic() - t0

    try:
        # (a) the CSVs through POST /dataset/csv, every row in the core
        t0 = time.monotonic()
        sizes = {("b4train", BASELINE4_ROWS, 21): None,
                 ("b4test", BASELINE4_SIDE_ROWS, 22): None,
                 ("b4eval", BASELINE4_SIDE_ROWS, 23): None}
        for key in sizes:
            sizes[key] = _write_baseline4_csv(
                np, os.path.join(home, f"{key[0]}.csv"), key[1], key[2])
        write_seconds = time.monotonic() - t0
        train = sizes[("b4train", BASELINE4_ROWS, 21)]
        train_path = os.path.join(home, "b4train.csv")
        # the first INGEST_HEAD_ROWS rows, for (c)
        head_path = os.path.join(home, "b4head.csv")
        with open(train_path, "rb") as f, open(head_path, "wb") as g:
            for _ in range(INGEST_HEAD_ROWS + 1):
                g.write(f.readline())
        ops.reset_counts()
        gc.collect()
        with _RssPeak() as rss:
            meta, ingest_seconds = ingest("b4train", train_path)
        for name in ("b4test", "b4eval"):
            ingest(name, os.path.join(home, f"{name}.csv"))
        counts = ops.counts()
        total = BASELINE4_ROWS + 2 * BASELINE4_SIDE_ROWS
        native_rows = counts.get("parse_csv", {}).get("native", {}).get(
            "rows")
        ingest_out = {
            "rows": meta.get("rows"), "fields": meta.get("fields"),
            "csvBytes": train["bytes"], "csvWriteSeconds": write_seconds,
            "ingestSeconds": ingest_seconds,
            "rowsPerSecond": BASELINE4_ROWS / ingest_seconds,
            "megabytesPerSecond": train["bytes"] / 1e6 / ingest_seconds,
            "rssGrowthBytes": rss.growth, "rssStartBytes": rss.start,
            "coreCounts": counts}
        out["ingest"] = ingest_out
        if meta.get("rows") != BASELINE4_ROWS or native_rows != total or \
                "python" in counts.get("parse_csv", {}) or \
                "deferredCells" in counts or \
                "ingestDelegated" in counts:
            raise AssertionError(f"(a) not every row through the core: "
                                 f"{ingest_out}")
        if rss.growth >= INGEST_RSS_BYTES:
            raise AssertionError(f"(a) resident memory grew "
                                 f"{rss.growth} bytes over the ingest")
        for (name, rows, _), info in sizes.items():
            os.remove(os.path.join(home, f"{name}.csv"))
            check_stored(name, rows, info.pop("written"))

        # (b) BASELINE config 4's streaming GB on the ingested datasets,
        # the first INGEST_GB_ROWS rows of b4train
        _write_dataset(ctx, "b4gb", [
            {col: np.array(data[:INGEST_GB_ROWS])
             for col, (_, data, _) in _stored(ctx, "b4train").items()}])
        gc.collect()
        tracemalloc.start()
        t0 = time.monotonic()
        uris = client.builder_sparkml.run_builder(
            "b4gb", "b4test", "", ["GB"], streaming=True,
            evaluationDatasetName="b4eval")
        gb_name = uris[0].rsplit("/", 1)[1]
        ctx.jobs.wait(gb_name, timeout=900)
        seconds = time.monotonic() - t0
        traced_peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        meta = client.builder_sparkml.metadata(gb_name)
        baseline4 = {
            "rows": INGEST_GB_ROWS, "jobSeconds": seconds,
            "fitTime": meta.get("fitTime"),
            "trainedRows": meta.get("trainedRows"),
            "trainedOnSample": meta.get("trainedOnSample"),
            "accuracy": meta.get("accuracy"), "f1": meta.get("f1"),
            "booster": meta.get("booster"), "native": native_fits == [True],
            "tracemallocPeakBytes": traced_peak,
            "outputRows": ctx.catalog.count_rows(gb_name)}
        out["baseline4"] = baseline4
        if not meta.get("finished") or \
                meta.get("trainedRows") != INGEST_GB_ROWS or \
                meta.get("trainedOnSample") is not False or \
                native_fits != [True] or \
                not meta.get("accuracy", 0) > BASELINE4_MIN_ACCURACY or \
                traced_peak >= BASELINE4_PEAK_BYTES or \
                baseline4["outputRows"] != BASELINE4_SIDE_ROWS:
            raise AssertionError(f"BASELINE config 4: {baseline4}")
        for name in ("b4gb", "b4test", "b4eval", gb_name):
            ctx.catalog.delete_collection(name)

        # (c) the head through both paths; the query over 10M rows
        head = {}
        for name, env in (("b4head", None), ("b4headPy", "0")):
            if env is not None:
                os.environ["LO_NATIVE"] = env
            try:
                ops.reset_counts()
                _, seconds = ingest(name, head_path)
            finally:
                os.environ.pop("LO_NATIVE", None)
            path = "python" if env else "native"
            rows = ops.counts().get("parse_csv", {}).get(path, {}).get(
                "rows")
            if rows != INGEST_HEAD_ROWS:
                raise AssertionError(f"(c) {name}: {ops.counts()}")
            head[path] = {"seconds": seconds,
                          "usPerRow": seconds / INGEST_HEAD_ROWS * 1e6}
        core_cols, py_cols = _stored(ctx, "b4head"), _stored(ctx, "b4headPy")
        head["storedEqual"] = list(core_cols) == list(py_cols) and all(
            core_cols[c][0] == py_cols[c][0]
            and core_cols[c][1].dtype == py_cols[c][1].dtype
            and np.array_equal(np.asarray(core_cols[c][1]).view(np.uint8),
                               np.asarray(py_cols[c][1]).view(np.uint8))
            for c in core_cols)
        head["coreSpeedup"] = head["python"]["seconds"] / \
            head["native"]["seconds"]
        out["head"] = head
        if not head["storedEqual"]:
            raise AssertionError("(c) the paths stored different columns")
        ordered = sorted(train["matches"])
        picked = ordered[INGEST_QUERY_SKIP:
                         INGEST_QUERY_SKIP + INGEST_QUERY_LIMIT]
        want = []
        for row in picked:
            k, label = train["matches"][row]
            doc = {f"f{j}": float(k[j] / 10 ** INGEST_DECIMALS)
                   for j in range(5)}
            doc["label"] = label
            doc["_id"] = row + 1
            want.append(doc)
        ops.reset_counts()
        status, body, query_seconds = page(
            "b4train", INGEST_QUERY, INGEST_QUERY_SKIP, INGEST_QUERY_LIMIT)
        query_counts = ops.counts().get("filter_mask", {})
        # the head through the mask and through the per-row loop
        head_query = {}
        for path in ("native", "perRow"):
            real = ops.filter_mask
            if path == "perRow":
                ops.filter_mask = lambda *a, **k: None
            try:
                t0 = time.monotonic()
                got = ctx.catalog.read_entries(
                    "b4head", skip=INGEST_QUERY_SKIP,
                    limit=INGEST_QUERY_LIMIT, query=INGEST_QUERY)
                head_query[path] = {"seconds": time.monotonic() - t0,
                                    "page": got}
            finally:
                ops.filter_mask = real
        query = {"matches": len(ordered), "status": status,
                 "seconds": query_seconds,
                 "pageEqualsNumpy": body.get("result") == want,
                 "maskRows": query_counts,
                 "headMaskSeconds": head_query["native"]["seconds"],
                 "headPerRowSeconds": head_query["perRow"]["seconds"],
                 "headPagesEqual": head_query["native"]["page"] ==
                 head_query["perRow"]["page"]}
        out["query"] = query
        if status != 200 or not query["pageEqualsNumpy"] or \
                not query["headPagesEqual"] or \
                query_counts.get("native", {}).get("rows", 0) < 1 or \
                len(picked) != INGEST_QUERY_LIMIT:
            raise AssertionError(f"(c) the query: {query}, "
                                 f"{body.get('result')} != {want}")

        # (d) the label histogram over 10M rows, and the head both ways
        def histogram(name, out_name):
            t0 = time.monotonic()
            client.explore_histogram.run_histogram(name, out_name,
                                                   ["label"])
            ctx.jobs.wait(out_name, timeout=900)
            seconds = time.monotonic() - t0
            docs = client.explore_histogram.read(out_name)["result"]
            buckets = [d for d in docs if "label" in d]
            return (buckets[0]["label"] if buckets else docs), seconds

        ops.reset_counts()
        buckets, hist_seconds = histogram("b4train", "b4hist")
        hist_counts = ops.counts().get("value_counts", {})
        head_hist = {}
        for name, env in (("b4head", None), ("b4headPy", "0")):
            if env is not None:
                os.environ["LO_NATIVE"] = env
            try:
                head_hist[env or "1"] = histogram(name, name + "Hist")
            finally:
                os.environ.pop("LO_NATIVE", None)
        hist = {"buckets": buckets, "seconds": hist_seconds,
                "coreRows": hist_counts,
                "headCoreSeconds": head_hist["1"][1],
                "headPythonSeconds": head_hist["0"][1],
                "headEqual": head_hist["1"][0] == head_hist["0"][0]}
        out["histogram"] = hist
        want_buckets = sorted(zip([0, 1], train["labels"].tolist()))
        if sorted((b["_id"], b["count"]) for b in buckets) != \
                [(v, c) for v, c in want_buckets if c] or \
                hist_counts.get("native", {}).get("rows") != \
                BASELINE4_ROWS or not hist["headEqual"]:
            raise AssertionError(f"(d) the histogram: {hist}")

        # (e) the batch gather at ResNet-50's input width
        rng = np.random.default_rng(5)
        src = rng.random((GATHER_ROWS, GATHER_WIDTH), dtype=np.float32)
        idx = rng.integers(0, GATHER_ROWS, GATHER_BATCH)
        ops.reset_counts()
        gathered = ops.gather_rows(src, idx)
        core_calls = ops.counts().get("gather_rows", {}).get(
            "native", {}).get("calls")
        times = {"core": [], "numpy": []}
        for _ in range(5):
            for key, fn in (("core", lambda: ops.gather_rows(src, idx)),
                            ("numpy", lambda: src[idx])):
                t0 = time.perf_counter()
                fn()
                times[key].append((time.perf_counter() - t0) * 1e3)
        gather = {"shape": [GATHER_BATCH, GATHER_WIDTH],
                  "bitEqual": bool(np.array_equal(
                      gathered.view(np.uint32), src[idx].view(np.uint32))),
                  "coreCalls": core_calls, "coreMs": min(times["core"]),
                  "numpyMs": min(times["numpy"])}
        out["gather"] = gather
        del src, gathered
        if not gather["bitEqual"] or core_calls != 1:
            raise AssertionError(f"(e) the gather: {gather}")
    finally:
        hgb.HistGB.fit_binned = fit_binned
        server.stop()
        ctx.close()
    launches = _launches(attn)
    if any(launches.values()):
        raise AssertionError(f"the ingest path launched {launches}")
    out["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("ingest " + json.dumps(out))
    return {"ingest": launches}


def _lm_job(base, name, params, timeout=None):
    body = {"name": name, "modelName": "lm", "method": "fit",
            "methodParameters": params}
    if timeout is not None:
        body["timeout"] = timeout
    status, answer = _http(base, "POST", "/train/tensorflow", body)
    if status != 201:
        raise AssertionError(f"POST {name}: {status} {answer}")


def _job_docs(base, verb, name):
    return _http(base, "GET", f"/{verb}/tensorflow/{name}")[1]


def lifecycle_phase(torch, log, home, yard):
    """The job lifecycle on the card (the ``lifecycle`` line). (a) The
    tutorial LM's bf16 fit over REST (the pipeline's 64 windows, batch
    16, grad_accum 2): a ``DELETE .../run`` after its first step ends it
    ``cancelled`` within 2 steps' time, and ``"timeout": 2`` ends another
    ``timedOut``; for each, the card memory at the start of the job
    queued behind it is within 1 MiB of before the fit, and the sm90
    counters stop. (b) The health sentinel on the tutorial CNN (1024
    MNIST-shaped rows, batch 256, 3 epochs, no shuffle) under
    ``engine_step:1:nan``: ``skip`` keeps the losses finite and counts
    the step; ``rollback`` with ``"checkpoint": true`` ends within 1e-5
    relative of a clean run's losses; ``fail`` (every epoch poisoned)
    dead-letters after ``LO_HEALTH_RETRIES``; the CNN's step ms with
    ``skip`` and without a policy. (c) Boot recovery: a server process
    killed with SIGKILL after the first epoch of a checkpointed 2-epoch
    LM fit; the restarted server requeues it, its epoch 2 equals the
    uninterrupted fit's loss bit for bit with exactly 64 launches of each
    sm90 kernel and nothing else, and an unfinished projection gets its
    ``InterruptedError``. (d) The gateway: at ``LO_REQUEST_TIMEOUT`` 0.5 a
    slow read answers 504 and its dispatch runs to its end. Returns the
    launches of the cancelled, timed-out and resumed fits."""
    import signal

    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.neural import NeuralModel
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime import arena as arena_lib
    from learningorchestra_tpu_torch.services import faults
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import Api, RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    phase_t0 = time.monotonic()
    out: dict = {}
    paths: dict = {}
    x = _successor_windows(np, TRAIN_WINDOWS, TRAIN_SEQ, seed=0)
    steps_per_epoch = TRAIN_WINDOWS // TRAIN_BATCH
    step_launches = LM_CONFIG["n_layers"] * TRAIN_ACCUM
    fit = {"x": "$corpus.tokens", "batch_size": TRAIN_BATCH,
           "epochs": TRAIN_EPOCHS, "grad_accum": TRAIN_ACCUM}

    # the uninterrupted fit: the resumed epoch's yardstick and the step
    # time (it also warms what a fit keeps for the process)
    lm = LanguageModel(**LM_CONFIG, device="cuda")
    lm.set_params(weights.params_from_flax(
        weights.init_params(LM_CONFIG, seed=0)))
    hist = lm.fit(x, batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                  grad_accum=TRAIN_ACCUM).history
    reference = hist["loss"]
    step_s = hist["epochSeconds"][1] / steps_per_epoch
    del lm, hist

    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    try:
        _save_arrays(ctx, "corpus", {"tokens": x})
        status, answer = _http(base, "POST", "/model/tensorflow", {
            "modelName": "lm", "modulePath": "learningorchestra_tpu.models",
            "class": "LanguageModel", "classParameters": LM_CONFIG})
        if status != 201:
            raise AssertionError(f"POST /model lm: {status} {answer}")
        _poll(base, "/model/tensorflow/lm")

        # (a) cancel, then timeout, each with a probe job queued behind
        def probe(name):
            ctx.catalog.create_collection(name, "evaluate/tensorflow", {})

            def run():
                t = time.monotonic()
                return {"t": t, "launches": _launches(attn),
                        "bytes": _card_bytes(torch),
                        "arenaBytes": arena_lib.get_default_arena()
                        .stats()["bytesInUse"],
                        "peak": torch.cuda.max_memory_allocated()}

            # the fit's own pool: a job of another pool would take the
            # card at the fit's epoch boundary, with the fit's tensors
            # still on it
            ctx.jobs.submit(name, run, needs_card=True, pool="train")

        lifecycle = {}
        for name, timeout in (("lm_cancel", None), ("lm_timeout", 2)):
            before = _card_bytes(torch)
            before_arena = arena_lib.get_default_arena().stats()[
                "bytesInUse"]
            torch.cuda.reset_peak_memory_stats()
            _reset_launches(attn)
            t_post = time.monotonic()
            _lm_job(base, name, fit, timeout)
            probe(f"{name}_next")
            if timeout is None:
                # the first step is enqueued: cancel
                while attn.FLASH_FWD_SM90_LAUNCHES < step_launches:
                    if time.monotonic() - t_post > 120:
                        raise AssertionError("the fit never stepped")
                    time.sleep(0.002)
                t_cancel = time.monotonic()
                status, answer = _http(base, "DELETE",
                                       f"/train/tensorflow/{name}/run")
                if status != 200:
                    raise AssertionError(f"cancel: {status} {answer}")
            nxt = ctx.jobs.wait(f"{name}_next", timeout=600)
            ended = _job_docs(base, "train", name)
            want_status = "cancelled" if timeout is None else "timedOut"
            last = ended["result"][-1]
            if ended["metadata"].get("status") != want_status or \
                    last.get("status") != want_status or \
                    ended["metadata"]["finished"]:
                raise AssertionError(f"{name} ended {ended['metadata']}, "
                                     f"{last}")
            launched = nxt["launches"]
            time.sleep(0.5)
            if _launches(attn) != launched:
                raise AssertionError(f"{name}: launches went on after it "
                                     f"ended")
            stepped = launched["flash_fwd_sm90"] // step_launches
            # card bytes less the device arena's (a staged fit's entry may
            # stay for a repeat job), then after the arena is cleared
            freed = (nxt["bytes"] - nxt["arenaBytes"]) - \
                (before - before_arena)
            arena_lib.get_default_arena().clear()
            cleared = _card_bytes(torch) - (before - before_arena)
            record = {"status": want_status, "launches": launched,
                      "stepsLaunched": stepped,
                      "cardBytesBefore": before,
                      "arenaBytesBefore": before_arena,
                      "cardBytesAtNextJob": nxt["bytes"],
                      "arenaBytesAtNextJob": nxt["arenaBytes"],
                      "cardBytesLeft": freed,
                      "cardBytesLeftAfterArenaClear": cleared,
                      "peakBytesDuringFit": nxt["peak"],
                      "elapsedSeconds": last.get("elapsedSeconds"),
                      "exception": last.get("exception")}
            if abs(freed) > 1 << 20 or abs(cleared) > 1 << 20:
                raise AssertionError(f"{name} left {freed} bytes: {record}")
            if any(n for k, n in launched.items()
                   if not k.endswith("_sm90")) or \
                    launched["flash_bwd_dkv_sm90"] > \
                    launched["flash_fwd_sm90"]:
                raise AssertionError(f"{name} launched {launched}")
            if timeout is None:
                record["cancelToNextJobSeconds"] = nxt["t"] - t_cancel
                # two steps, and the collection and the handoff
                limit = 2 * step_s + 0.5
                record["limitSeconds"] = limit
                if record["cancelToNextJobSeconds"] > limit:
                    raise AssertionError(f"the cancel took {record}")
            else:
                record["postToNextJobSeconds"] = nxt["t"] - t_post
            lifecycle[name] = record
            paths["lifecycleCancel" if timeout is None
                  else "lifecycleTimeout"] = launched
        out["cancelAndTimeout"] = lifecycle
        out["stepSeconds"] = step_s

        # (b) the health sentinel on the tutorial CNN, over REST
        rx, ry = _mnist_like(np, REST_ROWS, seed=1)
        _save_arrays(ctx, "mnist", {"x": rx, "y": ry})
        status, answer = _http(base, "POST", "/model/tensorflow", {
            "modelName": "cnn", "modulePath": "learningorchestra_tpu.models",
            "class": "NeuralModel",
            "classParameters": {"layer_configs": TUTORIAL_CNN}})
        if status != 201:
            raise AssertionError(f"POST /model cnn: {status} {answer}")
        _poll(base, "/model/tensorflow/cnn")
        cnn_fit = {"x": "$mnist.x", "y": "$mnist.y", "epochs": 3,
                   "batch_size": MNIST_BATCH, "shuffle": False}

        def cnn_job(name, spec, policy, **extra):
            ctx.config.fault_inject = spec
            faults.reset()
            status, answer = _http(base, "POST", "/train/tensorflow", {
                "name": name, "modelName": "cnn", "method": "fit",
                "methodParameters": dict(cnn_fit, **extra),
                "healthPolicy": policy})
            if status != 201:
                raise AssertionError(f"POST {name}: {status} {answer}")
            ctx.jobs.wait(name, timeout=600)
            body = _job_docs(base, "train", name)
            losses = [d["epochRecord"]["loss"] for d in body["result"]
                      if "epochRecord" in d]
            return body, losses

        health = {}
        _, clean = cnn_job("cnn_clean", "", "rollback")
        body, skipped = cnn_job("cnn_skip", "engine_step:1:nan", "skip")
        meta = body["metadata"]
        if not (meta["finished"] and all(np.isfinite(skipped)) and
                meta.get("nonfiniteSteps", 0) >= 1):
            raise AssertionError(f"skip: {skipped}, {meta}")
        health["skip"] = {"losses": skipped,
                          "nonfiniteSteps": meta["nonfiniteSteps"],
                          "healthEvents": meta["healthEvents"]}
        body, rolled = cnn_job("cnn_rollback", "engine_step:1:nan",
                               "rollback", checkpoint=True)
        meta = body["metadata"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(rolled, clean))
        if not (meta["finished"] and meta.get("rollbacks") == 1 and
                len(rolled) == len(clean) == 3 and rel <= 1e-5):
            raise AssertionError(f"rollback: {rolled} vs clean {clean}; "
                                 f"{meta}")
        health["rollback"] = {"losses": rolled, "cleanLosses": clean,
                              "maxRelToClean": rel,
                              "bitEqualToClean": rolled == clean,
                              "rollbacks": meta["rollbacks"],
                              "restoredStep": meta["healthEvents"][0].get(
                                  "restoredStep")}
        body, _ = cnn_job("cnn_fail", "engine_step:99:nan", "fail")
        docs = [d for d in body["result"] if d.get("exception")]
        retries = ctx.config.health_retries
        if body["metadata"].get("status") != "deadLettered" or \
                len(docs) != retries + 1 or \
                not all("NumericalDivergence" in d["exception"] and
                        d["errorKind"] == "numerical" for d in docs) or \
                not docs[-1].get("deadLettered"):
            raise AssertionError(f"fail: {body['metadata']}, {docs}")
        health["fail"] = {"attempts": len(docs),
                          "exception": docs[-1]["exception"],
                          "retriesSkipped": docs[-1].get("retriesSkipped")}
        ctx.config.fault_inject = ""
        faults.reset()

        # the sentinel's cost on a host-bound step: skip against no
        # policy, in turns (none, skip, skip, none), 40 steps each
        tx, ty = _mnist_like(np, MNIST_BATCH * 40, seed=2)
        timing = {"none": [], "skip": []}
        for policy in ("none", "skip", "skip", "none"):
            model = NeuralModel(TUTORIAL_CNN, device="cuda")
            model.fit(tx[:MNIST_BATCH], ty[:MNIST_BATCH],
                      batch_size=MNIST_BATCH, epochs=1)  # first use
            hist = model.fit(tx, ty, batch_size=MNIST_BATCH, epochs=1,
                             health_policy=None if policy == "none"
                             else policy).history
            timing[policy].append(hist["epochSeconds"][0] / 40 * 1e3)
            del model
        health["stepMs"] = timing
        health["skipOverNoneStepMs"] = (sum(timing["skip"]) -
                                        sum(timing["none"])) / 2
        out["health"] = health

        # (d) the gateway: a slow read past the deadline
        big = 10000
        ctx.catalog.create_collection("big", "dataset/csv", {})
        with ctx.catalog.dataset_writer("big") as writer:
            writer.write_batch({f"c{i}": np.arange(big) + i
                                for i in range(200)})
        ctx.catalog.mark_finished("big")
        ctx.config.request_timeout_seconds = 0.5
        try:
            t0 = time.monotonic()
            status, answer = _http(base, "GET", "/dataset/csv/big")
            answered = time.monotonic() - t0
        finally:
            ctx.config.request_timeout_seconds = 0.0
        gateway = server.api.gateway
        deadline = time.monotonic() + 120
        while gateway["inflight"] or gateway["abandonedInflight"]:
            if time.monotonic() > deadline:
                raise AssertionError(f"the read never ended: {gateway}")
            time.sleep(0.05)
        ran = time.monotonic() - t0
        if status != 504 or answered > 1.5 or \
                gateway["abandonedTotal"] != 1:
            raise AssertionError(f"gateway: {status} {answer} after "
                                 f"{answered} s; {gateway}")
        out["gateway"] = {"status": status, "answer": answer["result"],
                          "answeredSeconds": answered,
                          "dispatchSeconds": ran, "counters": dict(gateway)}
        out["lifecycleCounters"] = ctx.jobs.lifecycle_counters()
    finally:
        ctx.config.fault_inject = ""
        faults.reset()
        server.stop()

    # (c) boot recovery in a server process of its own
    rhome = os.path.join(home, "recovery")
    rctx = ServiceContext(Config(home=rhome), device="cuda")
    try:
        _save_arrays(rctx, "corpus", {"tokens": x})
        Api(rctx).dispatch("POST", PREFIX + "/model/tensorflow", {}, {
            "modelName": "lm", "modulePath": "learningorchestra_tpu.models",
            "class": "LanguageModel", "classParameters": LM_CONFIG})
        rctx.jobs.wait("lm", timeout=600)
    finally:
        rctx.close()
    del rctx
    gc.collect()
    progress = os.path.join(rhome, "checkpoints", "lm_boot", "progress.json")

    def start():
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        proc = subprocess.Popen(
            [sys.executable, "-c", RECOVERY_SERVER, "--home", rhome,
             "--port", "0", "--device", "cuda"], env=env,
            stdout=subprocess.PIPE, text=True)
        line = proc.stdout.readline()
        if "REST on http://" not in line:
            proc.kill()
            raise AssertionError(f"the server did not start: {line!r}")
        return (proc, line.split("REST on ")[1].split(PREFIX)[0].strip(),
                proc.stdout.readline())

    recovery = {}
    t0 = time.monotonic()
    proc, rbase, _ = start()
    try:
        recovery["firstStartSeconds"] = time.monotonic() - t0
        _lm_job(rbase, "lm_boot", dict(fit, checkpoint=True))
        # the kill comes after the first epoch's commit and after its
        # record, which the fit appends just after the commit
        while True:
            if time.monotonic() - t0 > 600:
                raise AssertionError("no first epoch commit and record")
            try:
                with open(progress) as f:
                    committed = json.load(f).get("epochs_done") == 1
            except (OSError, ValueError):
                committed = False
            if committed and any(
                    d.get("epochRecord", {}).get("epoch") == 0
                    for d in _job_docs(rbase, "train", "lm_boot")["result"]):
                break
            time.sleep(0.01)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(progress) as f:
        if json.load(f)["epochs_done"] != 1:
            raise AssertionError("the server was killed after epoch 2")
    from learningorchestra_tpu_torch.catalog.store import Catalog

    cat = Catalog(os.path.join(rhome, "catalog.sqlite"),
                  os.path.join(rhome, "datasets"))
    cat.create_collection("proj", "transform/projection",
                          {"parentName": "corpus", "fields": ["t0"]})
    cat.close()
    t1 = time.monotonic()
    proc, rbase, recovered = start()
    try:
        recovery["restartSeconds"] = time.monotonic() - t1
        recovery["recovered"] = recovered.strip()
        if "'requeued': ['lm_boot']" not in recovered or \
                "'failed': ['proj']" not in recovered:
            raise AssertionError(f"recovered at start: {recovered}")
        meta = _poll(rbase, "/train/tensorflow/lm_boot")
        body = _job_docs(rbase, "train", "lm_boot")
        proj = _job_docs(rbase, "transform", "proj")
        recovery["resumeJobSeconds"] = time.monotonic() - t1
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            tail, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            tail, _ = proc.communicate()
    dumped = [line for line in tail.splitlines()
              if line.startswith("launches ")]
    if not dumped:
        raise AssertionError(f"the restarted server printed {tail!r}")
    resumed = json.loads(dumped[-1][len("launches "):])
    need = steps_per_epoch * step_launches
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_fwd_sm90=need, flash_bwd_dq_sm90=need,
                flash_bwd_dkv_sm90=need)
    records = [d["epochRecord"] for d in body["result"]
               if "epochRecord" in d]
    if resumed != want or [r["epoch"] for r in records] != [0, 1] or \
            records[1]["loss"] != reference[1] or \
            not meta.get("checkpointRestores"):
        raise AssertionError(f"the resumed fit: launches {resumed} (want "
                             f"{want}), records {records}, reference "
                             f"{reference}, metadata {meta}")
    if not proj["result"][-1].get("exception", "").startswith(
            "InterruptedError("):
        raise AssertionError(f"the projection: {proj['result'][-1]}")
    recovery.update(
        resumedLaunches=resumed, losses=[r["loss"] for r in records],
        referenceLosses=reference, epoch2BitEqual=True,
        restoredStep=meta["checkpointRestores"][0]["step"],
        restoreSeconds=meta["checkpointRestores"][0]["seconds"],
        projection=proj["result"][-1]["exception"])
    paths["lifecycleResumedEpoch"] = resumed
    out["bootRecovery"] = recovery
    out["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("lifecycle " + json.dumps(out))
    return paths


# ----------------------------------------------------------------------
# the observability plane (docs/OBSERVABILITY.md) on the card
# the bf16 fit's plane-cost windows: alternating on/off, each a job of
# COST_EPOCHS epochs of 8 steps (twice the training path's windows). An
# epoch's mean step varies by ~2% on an H100 with the plane on or off,
# and the ratio of two medians of 8 epochs by ~1.5% from run to run; a
# plane that costs ~0.5% then crossed the 3% gate about once in 25 runs.
# 24 epochs a side cut that spread to ~0.9% (the gate is unchanged).
COST_WINDOWS, COST_EPOCHS, COST_LM_WINDOWS = 16, 3, 128
# the tutorial CNN's cost windows (host-bound: recorded, not gated)
COST_CNN_WINDOWS, COST_CNN_ROWS, COST_CNN_BATCH = 4, 8192, 256
# the float32 slot session's prompts and decode length
OBS_PROMPT, OBS_NEW = 256, 8
# the plane's knobs of docs/OBSERVABILITY.md "CI gate"
# the scheduler phase: the yielding fit's epochs (4 steps each), and the
# short fits' corpus: the first 16 windows, one step an epoch
SCHED_EPOCHS = 3
SCHED_SHORT_WINDOWS = 16
# how long (d)'s fit must stay queued behind the hold session
SCHED_HOLD_SECONDS = 1.0


def _finish_order(events_path: str, names) -> list:
    """The jobs among ``names`` in the order the server logged them
    finished (its event log)."""
    order = []
    with open(events_path) as f:
        for line in f:
            event = json.loads(line)
            if event.get("kind") == "job" and event.get("name") == \
                    "finished" and event.get("traceId") in names:
                order.append(event["traceId"])
    return order


def scheduler_phase(torch, log, home, yard):
    """The card's fair lease over REST (the ``scheduler`` line), each
    check on one server over one home, in bf16 (fits and evaluates) and
    float32 (the session). (a) A fit of the tutorial LM in pool ``train``
    (the pipeline's 64 windows, batch 16, grad_accum 2, 3 epochs); once
    its first epoch's launches are in, an ``evaluate`` (pool
    ``evaluate``) of an unyielded fit of the same seed and data run just
    before: the evaluate finishes first, the fit's document has
    ``leaseYields`` >= 1 and ``preemptedSeconds`` > 0, its losses equal
    the unyielded fit's bit for bit, and ``meshScheduler.grantsByPool``
    and ``meshSecondsByPool`` name both pools. (b) ``memory_allocated``
    at the yield and while the evaluate runs: the yielded fit's bytes
    stay resident. (c) A float32 slot session of the seeded tutorial LM
    serving ``PROMPT_LENS`` prompts of ``NEW_TOKENS``: a warm round, a
    round with a 1-epoch fit posted as it starts (the session yields
    mid-stream), and a round sent while a fit holds the card; every
    request's tokens equal solo ``generate``; the session's
    ``lease.yields`` >= 1 and equal to ``lo_serving_lease_yields_total``;
    the fits finish while the session lives; each round's TTFT. (d)
    ``LO_SERVE_LEASE_POLICY=hold``: a fit queued behind a live session
    does not start until the session is deleted, its
    ``leaseWaitSeconds`` at least the time until the delete, the
    session's yields 0. (e) ``LO_MESH_YIELD=0``: (a) again with 1-step
    epochs; the fit never yields and the evaluate waits for its end.
    Returns the launches of (a) to (e)."""
    import contextlib

    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime import preempt
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    phase_t0 = time.monotonic()
    lo_home = os.path.join(home, "lo")
    events = os.path.join(home, "events.jsonl")
    x = _successor_windows(np, TRAIN_WINDOWS, TRAIN_SEQ, seed=0)
    fit = {"x": "$corpus.tokens", "batch_size": TRAIN_BATCH,
           "epochs": SCHED_EPOCHS, "grad_accum": TRAIN_ACCUM}
    short = dict(fit, x="$short.tokens", epochs=1)
    epoch_launches = LM_CONFIG["n_layers"] * TRAIN_ACCUM * (
        TRAIN_WINDOWS // TRAIN_BATCH)
    out: dict = {}

    @contextlib.contextmanager
    def server(**fields):
        ctx = ServiceContext(Config(home=lo_home, event_log=events,
                                    **fields), device="cuda")
        srv = RestServer(port=0, context=ctx).start()
        try:
            yield ctx, srv.base_url
        finally:
            srv.stop()

    def post(base, path, body, want=201):
        status, answer = _http(base, "POST", path, body)
        if status != want:
            raise AssertionError(f"POST {path}: {status} {answer}")
        return answer

    def job(base, verb, name, model, method, params):
        post(base, f"/{verb}/tensorflow", {
            "name": name, "modelName": model, "method": method,
            "methodParameters": params})

    def finished(base, verb, name) -> dict:
        _poll(base, f"/{verb}/tensorflow/{name}", interval=0.02)
        return _job_docs(base, verb, name)

    def losses(docs) -> list:
        return [d["epochRecord"]["loss"] for d in docs["result"]
                if "epochRecord" in d]

    def until(what, predicate, timeout=120.0):
        deadline = time.monotonic() + timeout
        while not predicate():
            if time.monotonic() > deadline:
                raise AssertionError(f"timed out waiting for {what}")
            time.sleep(0.002)

    # the session's seeded weights and their solo tokens, outside the
    # counted path
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, LM_CONFIG["vocab_size"],
                                             size=n)] for n in PROMPT_LENS]
    served = LanguageModel(**LM_CONFIG, device="cuda")
    served.set_params(weights.params_from_flax(
        weights.init_params(LM_CONFIG, seed=0)))
    solos = [served.generate([p], max_new_tokens=NEW_TOKENS)[0][len(p):]
             for p in prompts]

    with server() as (ctx, base):
        _save_arrays(ctx, "corpus", {"tokens": x})
        _save_arrays(ctx, "short", {"tokens": x[:SCHED_SHORT_WINDOWS]})
        ctx.artifacts.save(served, "sch_srv", "train/tensorflow")
        del served
        post(base, "/model/tensorflow", {
            "modelName": "lm", "modulePath": "learningorchestra_tpu.models",
            "class": "LanguageModel", "classParameters": LM_CONFIG})
        _poll(base, "/model/tensorflow/lm", interval=0.02)
        _reset_launches(attn)

        # (a) the unyielded fit, then the same fit with an evaluate of
        # the first queued after its first epoch
        job(base, "train", "sch_ref", "lm", "fit", fit)
        ref = finished(base, "train", "sch_ref")
        memory: dict = {}
        real_yield = preempt.maybe_yield
        real_evaluate = LanguageModel.evaluate

        def recording_yield():
            # the fit's thread: a yield is about to hand the card over
            if preempt.contended() and "atYield" not in memory:
                torch.cuda.synchronize()
                memory["atYield"] = torch.cuda.memory_allocated()
            real_yield()

        def recording_evaluate(self, *args, **kwargs):
            # the evaluate's thread, its model on the card
            torch.cuda.synchronize()
            memory["duringEvaluate"] = torch.cuda.memory_allocated()
            return real_evaluate(self, *args, **kwargs)

        preempt.maybe_yield = recording_yield
        LanguageModel.evaluate = recording_evaluate
        try:
            torch.cuda.synchronize()
            memory["beforeFit"] = torch.cuda.memory_allocated()
            start = attn.FLASH_FWD_SM90_LAUNCHES
            job(base, "train", "sch_fit", "lm", "fit", fit)
            until("the fit's first epoch", lambda: (
                attn.FLASH_FWD_SM90_LAUNCHES - start >= epoch_launches))
            job(base, "evaluate", "sch_e", "sch_ref", "evaluate",
                {"x": "$corpus.tokens", "batch_size": TRAIN_BATCH})
            yielded = finished(base, "train", "sch_fit")
            evaluated = finished(base, "evaluate", "sch_e")
        finally:
            preempt.maybe_yield = real_yield
            LanguageModel.evaluate = real_evaluate
        doc = yielded["result"][-1]
        metrics = json.loads(_raw(base, "/metrics")[1])
        grants = metrics["meshScheduler"]["grantsByPool"]
        order = _finish_order(events, ("sch_fit", "sch_e"))
        out["yieldToAnotherPool"] = {
            "epochs": SCHED_EPOCHS, "finishOrder": order,
            "leaseYields": doc.get("leaseYields"),
            "preemptedSeconds": doc.get("preemptedSeconds"),
            "elapsedSeconds": doc.get("elapsedSeconds"),
            "leaseWaitSeconds": doc.get("leaseWaitSeconds"),
            "losses": losses(yielded), "unyieldedLosses": losses(ref),
            "evaluate": next((d["result"] for d in evaluated["result"]
                              if "result" in d), None),
            "evaluateLeaseWaitSeconds":
                evaluated["result"][-1].get("leaseWaitSeconds"),
            "grantsByPool": grants,
            "meshSecondsByPool": metrics["meshSecondsByPool"]}
        if order != ["sch_e", "sch_fit"] or \
                not (doc.get("leaseYields") or 0) >= 1 or \
                not (doc.get("preemptedSeconds") or 0) > 0 or \
                losses(yielded) != losses(ref) or \
                len(losses(ref)) != SCHED_EPOCHS or \
                not {"train", "evaluate"} <= set(grants) or \
                not {"train", "evaluate"} <= set(
                    metrics["meshSecondsByPool"]):
            raise AssertionError(f"(a) {out['yieldToAnotherPool']}")
        # (b) the yielded fit's bytes stayed on the card under the
        # evaluate
        memory["fitBytesAtYield"] = memory["atYield"] - memory["beforeFit"]
        out["memory"] = memory
        if not memory["fitBytesAtYield"] > 0 or \
                memory["duringEvaluate"] < memory["atYield"]:
            raise AssertionError(f"(b) {memory}")

        # (c) a session yields, mid-stream and while idle
        post(base, "/serve/sch_srv", {"type": "lm", "maxSlots": 4,
                                      "cacheLen": 2048, "temperature": 0.0})
        rounds = {}
        out_round, walls, _ = _predict_round(base, "sch_srv", prompts)
        rounds["warm"] = (out_round, walls)
        result: dict = {}

        def background_round():
            result["round"] = _predict_round(base, "sch_srv", prompts)

        thread = threading.Thread(target=background_round)
        thread.start()
        job(base, "train", "sch_mid", "lm", "fit", short)
        thread.join(timeout=600)
        rounds["midStream"] = result["round"][:2]
        finished(base, "train", "sch_mid")

        def lease():
            return _http(base, "GET", "/serve/sch_srv")[1]["lease"]

        before = lease()["yields"]
        job(base, "train", "sch_idle", "lm", "fit", short)
        until("the session's yield", lambda: lease()["yields"] > before
              or not lease()["held"])
        rounds["behindFit"] = _predict_round(base, "sch_srv", prompts)[:2]
        finished(base, "train", "sch_idle")
        stats = _http(base, "GET", "/serve/sch_srv")[1]
        prometheus = _raw(base, "/metrics?format=prometheus")[1].decode()
        counted = re.search(r"^lo_serving_lease_yields_total (\d+)$",
                            prometheus, re.M)
        session = {"yields": stats["lease"]["yields"],
                   "leaseWaitSeconds": stats["lease"]["waitSeconds"],
                   "promYields": int(counted.group(1)) if counted else None,
                   "fitsFinishedWhileLive": [
                       _job_docs(base, "train", n)["metadata"]["finished"]
                       for n in ("sch_mid", "sch_idle")]}
        for name, (results, client_walls) in rounds.items():
            _diverges(f"(c) {name}", _round_tokens(name, results), solos)
            session[name] = _round_rates(results, client_walls)
        session["addedTtftMsP50"] = {
            name: session[name]["clientTtftMs"]["p50"]
            - session["warm"]["clientTtftMs"]["p50"]
            for name in ("midStream", "behindFit")}
        status, _ = _http(base, "DELETE", "/serve/sch_srv")
        out["session"] = session
        if status != 200 or session["yields"] < 1 or \
                session["promYields"] != session["yields"] or \
                not all(session["fitsFinishedWhileLive"]):
            raise AssertionError(f"(c) {session}")

    # (d) a hold session keeps the card until it is deleted
    with server(serve_lease_policy="hold") as (ctx, base):
        post(base, "/serve/sch_srv", {"type": "lm", "maxSlots": 4,
                                      "cacheLen": 2048, "temperature": 0.0})
        fwd = attn.FLASH_FWD_SM90_LAUNCHES
        job(base, "train", "sch_hold", "lm", "fit", short)
        until("the fit to queue",
              lambda: ctx.jobs.scheduler_stats()["waiters"] == 1)
        t_queued = time.monotonic()
        time.sleep(SCHED_HOLD_SECONDS)
        status_while_held = ctx.catalog.get_metadata("sch_hold")["status"]
        launched_while_held = attn.FLASH_FWD_SM90_LAUNCHES - fwd
        t_delete = time.monotonic()
        status, final = _http(base, "DELETE", "/serve/sch_srv")
        meta = _poll(base, "/train/tensorflow/sch_hold", interval=0.02)
        hold = {"statusWhileHeld": status_while_held,
                "launchesWhileHeld": launched_while_held,
                "secondsUntilDelete": t_delete - t_queued,
                "leaseWaitSeconds": meta.get("leaseWaitSeconds"),
                "sessionYields": final["lease"]["yields"],
                "policy": final["lease"]["policy"]}
        out["hold"] = hold
        if status != 200 or status_while_held != "queued" or \
                launched_while_held or hold["sessionYields"] != 0 or \
                hold["policy"] != "hold" or \
                not hold["leaseWaitSeconds"] >= hold["secondsUntilDelete"]:
            raise AssertionError(f"(d) {hold}")

    # (e) LO_MESH_YIELD=0: the evaluate waits for the whole fit
    with server(mesh_yield=False) as (ctx, base):
        start = attn.FLASH_FWD_SM90_LAUNCHES
        job(base, "train", "sch_noyield", "lm", "fit",
            dict(short, epochs=SCHED_EPOCHS))
        until("the fit's first epoch", lambda: (
            attn.FLASH_FWD_SM90_LAUNCHES - start >=
            epoch_launches * SCHED_SHORT_WINDOWS // TRAIN_WINDOWS))
        job(base, "evaluate", "sch_e2", "sch_ref", "evaluate",
            {"x": "$short.tokens", "batch_size": TRAIN_BATCH})
        doc = finished(base, "train", "sch_noyield")["result"][-1]
        evaluated = finished(base, "evaluate", "sch_e2")["result"][-1]
        order = _finish_order(events, ("sch_noyield", "sch_e2"))
        noyield = {"finishOrder": order,
                   "leaseYields": doc.get("leaseYields"),
                   "preemptedSeconds": doc.get("preemptedSeconds"),
                   "evaluateLeaseWaitSeconds":
                       evaluated.get("leaseWaitSeconds")}
        out["meshYieldOff"] = noyield
        if order != ["sch_noyield", "sch_e2"] or \
                "leaseYields" in doc or "preemptedSeconds" in doc or \
                not noyield["evaluateLeaseWaitSeconds"] > 0:
            raise AssertionError(f"(e) {noyield}")

    launches = _launches(attn)
    out["launches"] = launches
    out["seconds"] = time.monotonic() - phase_t0
    # (a) two fits and an evaluate of the corpus; (c) two 1-epoch fits of
    # the short corpus and three rounds of float32 prefills; (d) one
    # 1-epoch fit; (e) a 3-epoch fit and an evaluate of the short corpus
    layers, accum = LM_CONFIG["n_layers"], TRAIN_ACCUM
    steps = 2 * SCHED_EPOCHS * TRAIN_WINDOWS // TRAIN_BATCH + \
        (3 + SCHED_EPOCHS) * SCHED_SHORT_WINDOWS // TRAIN_BATCH
    batches = (TRAIN_WINDOWS + SCHED_SHORT_WINDOWS) // TRAIN_BATCH
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_fwd_sm90=layers * (accum * steps + batches),
                flash_bwd_dq_sm90=layers * accum * steps,
                flash_bwd_dkv_sm90=layers * accum * steps,
                flash_fwd_tf32x3=layers * len(PROMPT_LENS) * 3)
    out["launchesWanted"] = want
    if launches != want:
        raise AssertionError(f"the scheduler path launched {launches}, "
                             f"want {want}")
    log.append("scheduler " + json.dumps(out))
    return {"scheduler": launches}


PLANE_ENV = ("LO_PERF", "LO_XRAY")


def _raw(base, path, method="GET", body=None):
    """``(status, bytes, content type)`` of ``path`` (no API prefix)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read(), resp.headers["Content-Type"]
    except urllib.error.HTTPError as err:
        return err.code, err.read(), err.headers["Content-Type"]


def _span_index(tree) -> dict:
    """name -> list of (span, parent span name) over a span tree."""
    out: dict = {}

    def walk(span, parent):
        out.setdefault(span["name"], []).append((span, parent))
        for child in span["children"]:
            walk(child, span["name"])

    for root in tree["spans"]:
        walk(root, None)
    return out


def _plane(ctx, on: bool):
    """Turns the plane's knobs (LO_TRACE, LO_PERF, LO_XRAY, LO_MONITOR)
    all on or all off; returns the monitor started (at the production
    tick of 1 s), or None."""
    from learningorchestra_tpu_torch.services import context as context_mod

    ctx.config.trace = on
    for key in PLANE_ENV:
        os.environ[key] = "1" if on else "0"
    if not on:
        return None
    ctx.config.monitor_interval_ms = 1000.0
    return context_mod._start_monitor(ctx)


def _cost_windows(ctx, fit, windows: int, prefix: str) -> dict:
    """Runs ``fit()`` (a list of step seconds, one an epoch) as jobs in
    windows alternating on, off, off, on (so a drift over the run weighs
    on both sides alike); the median step seconds of each side and their
    ratio."""
    steps = {True: [], False: []}
    for i in range(windows):
        on = i % 4 in (0, 3)
        monitor = _plane(ctx, on)
        name = f"{prefix}{i}"
        ctx.catalog.create_collection(name, "train/tensorflow", {})
        try:
            records = ctx.jobs.submit(name, fit, needs_card=True).result()
        finally:
            if monitor is not None:
                monitor.stop()
        if not records:
            raise AssertionError(f"cost window {name} failed: "
                                 f"{ctx.catalog.get_documents(name)[-1]}")
        steps[on] += records
    _plane(ctx, True)
    median = {k: sorted(v)[len(v) // 2] for k, v in steps.items()}
    return {"stepSecondsOn": steps[True], "stepSecondsOff": steps[False],
            "medianStepSecondsOn": median[True],
            "medianStepSecondsOff": median[False],
            "ratio": median[True] / median[False]}


def observe_phase(torch, log, home, yard):
    """The observability plane on the card, through the REST routes a
    user reads: (a) a checkpointed REST ``/train`` of the tutorial LM at
    full width in bf16 (the training path: 2 epochs of 4 steps of 2
    micro-batches of 8 x 2048 tokens) — the span tree, two timeline
    windows with the roofline fields, the perf report against the H100
    row (989.4 TFLOP/s), ``mfu`` in [0.02, 0.10] and exactly the
    pipeline fit's 128 launches of each sm90 kernel; (c) the X-ray
    report during that fit, with a float32 slot session resident; (d) a
    ``servingP99`` page under a ``serving_step`` latency fault: both
    windows breach, ``/healthz`` 503, an incident bundle with every
    section (a torch-profiler window among them) and no collector error,
    downloadable as a tar, then resolved and 200; (e) ``POST /profile``
    around two predicts: the Chrome trace's device events include the
    ``flash_fwd_tf32x3`` kernel; (b) ``/metrics`` as JSON and
    Prometheus; (f) the plane's cost on the bf16 fit's median step (all
    knobs on against all off, alternating windows, under 3%) and on the
    tutorial CNN's (recorded), each after one fit of first use. Returns
    the launches of (a) to (e) (``observe``) and of the cost windows and
    their first-use fit (``observeCost``)."""
    import io
    import tarfile

    import numpy as np

    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.neural import NeuralModel
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.services import faults
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    for key in PLANE_ENV:
        os.environ[key] = "1"
    phase_t0 = time.monotonic()
    x = _successor_windows(np, TRAIN_WINDOWS, TRAIN_SEQ, seed=0)
    events = os.path.join(home, "events.jsonl")
    ctx = ServiceContext(Config(
        home=os.path.join(home, "lo"), monitor_interval_ms=100.0,
        slo_serving_p99_ms=50.0, slo_fast_window_s=1.0,
        slo_slow_window_s=2.0, event_log=events, incident_profile_s=1.0),
        device="cuda")
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    steps = TRAIN_EPOCHS * TRAIN_WINDOWS // TRAIN_BATCH
    out: dict = {}
    launches: dict = {}

    def post(path, body, want=201):
        status, answer = _http(base, "POST", path, body)
        if status != want:
            raise AssertionError(f"POST {path}: {status} {answer}")
        return answer

    def get(path, want=200):
        status, answer = _http(base, "GET", path)
        if status != want:
            raise AssertionError(f"GET {path}: {status} {answer}")
        return answer

    def predict(n: int) -> list:
        return [post("/serve/obs_srv/predict", {
            "prompt": [int(t) for t in x[i % TRAIN_WINDOWS, :OBS_PROMPT]],
            "maxNewTokens": OBS_NEW}, 200) for i in range(n)]

    try:
        ctx.artifacts.save({"tokens": x}, "corpus", "function/python")
        ctx.catalog.create_collection("corpus", "function/python", {})
        ctx.catalog.mark_finished("corpus")
        post("/model/tensorflow", {
            "modelName": "obs_lm",
            "modulePath": "learningorchestra_tpu.models",
            "class": "LanguageModel", "classParameters": LM_CONFIG})
        _poll(base, "/model/tensorflow/obs_lm")
        # a resident float32 slot session of the tutorial LM (seeded
        # weights; the split-TF32 forward kernel on its prefills)
        served = LanguageModel(**LM_CONFIG, device="cuda")
        served.set_params(weights.params_from_flax(
            weights.init_params(LM_CONFIG, seed=1)))
        ctx.artifacts.save(served, "obs_srv", "train/tensorflow")
        del served
        post("/serve/obs_srv", {"type": "lm", "maxSlots": 4,
                                "cacheLen": 2 * OBS_PROMPT,
                                "temperature": 0.0})

        # (a) + (c): the checkpointed REST fit, the memory report read
        # while it runs
        _reset_launches(attn)
        post("/train/tensorflow", {
            "name": "obs_t", "modelName": "obs_lm", "method": "fit",
            "methodParameters": {"x": "$corpus.tokens",
                                 "batch_size": TRAIN_BATCH,
                                 "epochs": TRAIN_EPOCHS,
                                 "grad_accum": TRAIN_ACCUM,
                                 "checkpoint": True}})
        memory = None
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            report = get("/observability/memory")
            if report["owners"].get("train-state"):
                memory = report
                break
            if ctx.catalog.get_metadata("obs_t").get("finished"):
                break
            time.sleep(0.05)
        meta = _poll(base, "/train/tensorflow/obs_t")
        fit_launches = _launches(attn)
        need = LM_CONFIG["n_layers"] * steps * TRAIN_ACCUM
        want = dict.fromkeys(COUNTERS, 0)
        want.update(flash_fwd_sm90=need, flash_bwd_dq_sm90=need,
                    flash_bwd_dkv_sm90=need)
        if fit_launches != want:
            raise AssertionError(f"the observed fit launched {fit_launches}"
                                 f", want the pipeline fit's {want}")
        tree = get("/observability/trace/obs_t")
        spans = _span_index(tree)
        parents = {"submit": None, "validate": "submit",
                   "preflight": "submit", "job": None, "queueWait": "job",
                   "leaseWait": "job", "attempt": "job",
                   "dataLoad": "attempt", "epoch": "attempt",
                   "checkpointCommit": "attempt",
                   "artifactSave": "attempt"}
        counts = {"epoch": TRAIN_EPOCHS, "checkpointCommit": TRAIN_EPOCHS}
        for name, parent in parents.items():
            found = spans.get(name, [])
            if len(found) != counts.get(name, 1) or any(
                    p != parent for _, p in found):
                raise AssertionError(
                    f"span {name}: {[(s['spanId'], p) for s, p in found]}"
                    f" (want {counts.get(name, 1)} under {parent}); "
                    f"tree {json.dumps(tree)[:2000]}")
        timeline = get("/observability/timeline/obs_t")
        windows = timeline["timeline"]
        if len(windows) != TRAIN_EPOCHS or any(
                "mfu" not in w or "tflopsPerSecPerChip" not in w
                for w in windows):
            raise AssertionError(f"timeline {timeline}")
        perf = get("/observability/perf/obs_t")
        platform = perf["platform"]
        if "H100" not in platform.get("peakSource", "") or \
                platform["peakTflopsPerChip"] != 989.4:
            raise AssertionError(f"platform row {platform}")
        mfu = perf["perf"]["mfu"]
        if not 0.02 <= mfu <= 0.10:
            raise AssertionError(f"mfu {mfu} outside [0.02, 0.10]: the "
                                 f"count, the peak or the window is wrong")
        # the FLOPs per step the report implies, against the JAX floor
        # (6 x matmul params x tokens + 6 L s^2 d per window)
        lm = ctx.artifacts.load("obs_t")
        tokens = TRAIN_BATCH * TRAIN_SEQ
        floor = 6.0 * (lm.num_params() - lm.vocab_size * lm.d_model) * \
            tokens + 6.0 * lm.n_layers * TRAIN_BATCH * TRAIN_SEQ ** 2 * \
            lm.d_model
        epoch_s = windows[-1]["dtSeconds"]
        implied = windows[-1]["tflopsPerSecPerChip"] * 1e12 * epoch_s / \
            (steps // TRAIN_EPOCHS)
        if implied < 0.99 * floor:
            raise AssertionError(f"the window implies {implied:.4g} FLOPs "
                                 f"a step, under the floor {floor:.4g}")
        del lm
        if memory is None:
            raise AssertionError("the memory report never listed the "
                                 "fit's train-state")
        owners = memory["owners"]
        if not all(owners.get(o) for o in ("train-state", "serving-params",
                                           "kv-cache")) or \
                memory["bytesSource"] != "torchAllocator" or \
                not memory["bytesInUse"]:
            raise AssertionError(f"memory report {memory}")
        out["fit"] = {
            "losses": [w.get("loss") for w in windows],
            "epochSeconds": [w["dtSeconds"] for w in windows],
            "mfu": [w["mfu"] for w in windows],
            "tflopsPerSecPerChip": [w["tflopsPerSecPerChip"]
                                    for w in windows],
            "flopsPerStepFloor": floor, "flopsPerStepImplied": implied,
            "impliedOverFloor": implied / floor,
            "platform": platform, "perf": perf["perf"],
            "spans": {k: len(v) for k, v in spans.items()},
            "peakHbmBytes": meta.get("peakHbmBytes"),
            "checkpointCommitSeconds": meta.get("checkpointCommitSeconds"),
            "launches": fit_launches}
        out["xray"] = {
            "owners": owners, "bytesInUse": memory["bytesInUse"],
            "bytesReserved": memory["bytesReserved"],
            "attributedDeviceBytes": memory["attributedDeviceBytes"],
            "unattributedBytes": memory["unattributedBytes"],
            "unattributedShare": memory["unattributedBytes"] /
            max(1, memory["bytesInUse"])}

        # (d) the servingP99 page, its bundle, its resolution
        predict(2)  # first use of the session's prefill shapes
        ctx.config.fault_inject = "serving_step:100000:latency:0.25"
        faults.reset()
        # two clients keep requests landing while /healthz is polled (a
        # page resolves once a fast window passes with no slow request)
        stop = threading.Event()

        def load():
            while not stop.is_set():
                predict(1)

        clients = [threading.Thread(target=load, daemon=True)
                   for _ in range(2)]
        for client in clients:
            client.start()
        t0 = time.monotonic()
        fired = None
        try:
            while time.monotonic() - t0 < 60:
                status, body, _ = _raw(base, "/healthz")
                if status == 503:
                    fired = json.loads(body)
                    break
                time.sleep(0.05)
        finally:
            stop.set()
            for client in clients:
                client.join(timeout=60)
        if fired is None or not any(a["name"] == "servingP99"
                                    for a in fired.get("alerts", [])):
            raise AssertionError(f"/healthz never paged: {fired}")
        fire_s = time.monotonic() - t0
        bundle = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and bundle is None:
            listed = get("/observability/incidents")["result"]
            bundle = next((b for b in listed
                           if b["trigger"] == "slo:servingP99"), None)
            time.sleep(0.2)
        if bundle is None:
            raise AssertionError("no slo:servingP99 bundle was captured")
        manifest = get(f"/observability/incidents/{bundle['id']}")
        sections = ("cluster.json", "alerts.json", "memory.json",
                    "perf.json", "metrics.json", "eventlog.tail",
                    "config.json", "versions.json", "profile/trace.json")
        missing = [s for s in sections if s not in manifest["files"]]
        if missing or manifest["errors"]:
            raise AssertionError(f"bundle sections missing {missing}, "
                                 f"errors {manifest['errors']}")
        status, tar_bytes, ctype = _raw(
            base, f"{PREFIX}/observability/incidents/{bundle['id']}"
                  f"/download")
        with tarfile.open(fileobj=io.BytesIO(tar_bytes)) as tar:
            members = tar.getnames()
        if status != 200 or ctype != "application/x-tar" or not all(
                m.startswith(bundle["id"]) for m in members):
            raise AssertionError(f"bundle download {status} {ctype}")
        ctx.config.fault_inject = ""
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30:
            if _raw(base, "/healthz")[0] == 200:
                break
            time.sleep(0.1)
        else:
            raise AssertionError("/healthz stayed 503 after the fault")
        resolve_s = time.monotonic() - t0
        history = get("/observability/alerts")["history"]
        transitions = [h["transition"] for h in history
                       if h["name"] == "servingP99"]
        if transitions[-2:] != ["firing", "resolved"]:
            raise AssertionError(f"servingP99 transitions {transitions}")
        out["slo"] = {"fireSeconds": fire_s, "resolveSeconds": resolve_s,
                      "alert": fired["alerts"], "transitions": transitions,
                      "bundle": {"id": bundle["id"],
                                 "totalBytes": manifest["totalBytes"],
                                 "files": len(manifest["files"]),
                                 "tarMembers": len(members),
                                 "profileBytes": manifest["notes"].get(
                                     "profileBytes")}}

        # (e) POST /profile around two predicts
        started = post("/profile", {"action": "start"})
        predict(2)
        stopped = post("/profile", {"action": "stop"}, 200)
        with open(os.path.join(stopped["result"], "trace.json")) as f:
            chrome = json.load(f)
        kernels = [e for e in chrome.get("traceEvents", [])
                   if e.get("cat") == "kernel"]
        flash = [e for e in kernels if "flash_fwd_tf32x3" in e["name"]]
        if not flash:
            raise AssertionError(
                f"the profiler saw no flash_fwd_tf32x3 kernel among "
                f"{sorted({e['name'][:60] for e in kernels})[:20]}")
        out["profile"] = {"dir": started["result"],
                          "files": stopped["files"],
                          "kernelEvents": len(kernels),
                          "flashFwdTf32x3Events": len(flash),
                          "flashFwdTf32x3Us": sum(e.get("dur", 0)
                                                  for e in flash)}

        # (b) /metrics as JSON and as Prometheus text
        status, body, _ = _raw(base, "/metrics")
        metrics = json.loads(body)
        hists = metrics["latencyHistograms"]
        for key in ("lo_serving_request_seconds", "lo_dispatch_seconds",
                    "lo_lease_wait_seconds", "lo_checkpoint_commit_seconds"):
            if not hists.get(key, {}).get("count"):
                raise AssertionError(f"/metrics histogram {key}: "
                                     f"{hists.get(key)}")
        if "obs_t" not in metrics["perf"]["jobs"] or \
                "gateway" not in metrics:
            raise AssertionError(f"/metrics perf {metrics['perf']}")
        status, text, ctype = _raw(base, "/metrics?format=prometheus")
        text = text.decode()
        series = ('lo_mfu{job="obs_t"}', 'lo_tflops_per_chip{job="obs_t"}',
                  "lo_serving_request_seconds_bucket",
                  "lo_dispatch_seconds_bucket",
                  "lo_lease_wait_seconds_bucket",
                  "lo_checkpoint_commit_seconds_bucket",
                  "lo_gateway_inflight ", "lo_gateway_saturated_total ",
                  "lo_abandoned_dispatches ")
        missing = [s for s in series if s not in text]
        if missing or not ctype.startswith("text/plain"):
            raise AssertionError(f"prometheus lacks {missing}")
        out["metrics"] = {"jsonKeys": sorted(metrics),
                          "prometheusLines": len(text.splitlines()),
                          "histogramCounts": {k: v["count"]
                                              for k, v in hists.items()}}
        launches["observe"] = _launches(attn)
        if launches["observe"]["flash_fwd_tf32x3"] < LM_CONFIG["n_layers"]:
            raise AssertionError(f"the float32 session's prefills launched "
                                 f"{launches['observe']}")
        _http(base, "DELETE", "/serve/obs_srv")

        # (f) the plane's cost
        ctx.monitor.stop()
        lm = ctx.artifacts.load("obs_t")
        cost_x = _successor_windows(np, COST_LM_WINDOWS, TRAIN_SEQ, seed=1)
        per_epoch = COST_LM_WINDOWS // TRAIN_BATCH

        def lm_fit():
            hist = lm.fit(cost_x, batch_size=TRAIN_BATCH,
                          epochs=COST_EPOCHS,
                          grad_accum=TRAIN_ACCUM).history
            return [s / per_epoch for s in hist["epochSeconds"]]

        _reset_launches(attn)
        lm_fit()   # first use of the loaded model, outside the windows
        cost = _cost_windows(ctx, lm_fit, COST_WINDOWS, "cost_lm")
        launches["observeCost"] = _launches(attn)
        if cost["ratio"] >= 1.03:
            raise AssertionError(f"the plane costs the bf16 step "
                                 f"{(cost['ratio'] - 1) * 100:.2f}%: {cost}")
        del lm
        cx, cy = _mnist_like(np, COST_CNN_ROWS, seed=5)
        cnn = NeuralModel(TUTORIAL_CNN, device="cuda")
        cnn_steps = COST_CNN_ROWS // COST_CNN_BATCH

        def cnn_fit():
            hist = cnn.fit(cx, cy, batch_size=COST_CNN_BATCH,
                           epochs=COST_EPOCHS).history
            return [s / cnn_steps for s in hist["epochSeconds"]]

        cnn_fit()   # first use, outside the windows
        cnn_cost = _cost_windows(ctx, cnn_fit, COST_CNN_WINDOWS, "cost_cnn")
        out["cost"] = {"lmBf16": cost, "cnn": cnn_cost,
                       "monitorIntervalSeconds": 1.0}
    except BaseException:
        # what the phase measured before the failed check
        log.append("observe (failed) " + json.dumps(out, default=str))
        raise
    finally:
        for key in PLANE_ENV:
            os.environ[key] = "1"
        ctx.config.fault_inject = ""
        server.stop()
    out["phaseSeconds"] = time.monotonic() - phase_t0
    out["launches"] = launches
    log.append("observe " + json.dumps(out))
    return launches


# the feature plane (the featurePlane line): (c)'s Builder on the
# builder phase's wide shape, (e)'s and (f)'s arena budget, (g)'s child
FP_WIDE_MODELING = WIDE_MODELING
# (c)'s rows: hits, misses and equal predictions do not depend on the
# size
FP_BUILDER_ROWS = 50_000
FP_CANCEL_AT_STEP = 5
# optimizer steps in a profiled epoch: the LM's (2 steps, as the train
# phase's window), the CNN's 8 times as many
FP_PROFILE_STEPS = 2
# (b): ResNet-50's steps an epoch in its feed comparison, and the order
# of its runs
FP_RESNET_STEPS = 4
FP_RESNET_ORDER = ("perStep", "prefetch", "staged", "staged", "prefetch",
                   "perStep")
# (e): a budget that holds one staged copy of the wide dataset (72 MiB
# with its labels and mask) and not two, so the second evicts the first
FP_EVICT_BUDGET = 100 << 20
# (g): a child with the lock witness armed (count mode) runs (a)'s REST
# fit and one serving round, and prints its witness stats
FP_WITNESS_CHILD = (
    "import json, os, sys\n"
    "import numpy as np\n"
    "from learningorchestra_tpu_torch.runtime import locks\n"
    "from learningorchestra_tpu_torch.config import Config\n"
    "from learningorchestra_tpu_torch.ops import attention as attn\n"
    "from learningorchestra_tpu_torch.services.context import "
    "ServiceContext\n"
    "from learningorchestra_tpu_torch.services.server import Api\n"
    "home, windows = sys.argv[1], sys.argv[2]\n"
    "spec = json.loads(sys.argv[3])\n"
    "P = '/api/learningOrchestra/v1'\n"
    "ctx = ServiceContext(Config(home=home), device='cuda')\n"
    "api = Api(ctx)\n"
    "def call(method, path, body=None):\n"
    "    status, out = api.dispatch(method, P + path, {}, body)[:2]\n"
    "    if status not in (200, 201):\n"
    "        raise SystemExit(f'{method} {path}: {status} {out}')\n"
    "    return out\n"
    "x = np.load(windows)\n"
    "ctx.catalog.create_collection('corpus', 'dataset/csv', {})\n"
    "with ctx.catalog.dataset_writer('corpus') as w:\n"
    "    w.write_batch({f't{i}': x[:, i] for i in range(x.shape[1])})\n"
    "ctx.catalog.mark_finished('corpus')\n"
    "call('POST', '/model/tensorflow', {'modelName': 'lm',\n"
    "     'modulePath': 'learningorchestra_tpu.models',\n"
    "     'class': 'LanguageModel', 'classParameters': spec['config']})\n"
    "ctx.jobs.wait('lm', timeout=600)\n"
    "call('POST', '/train/tensorflow', {'name': 'lm_t', 'modelName': 'lm',\n"
    "     'method': 'fit', 'methodParameters': spec['fit']})\n"
    "ctx.jobs.wait('lm_t', timeout=600)\n"
    "losses = [d['epochRecord']['loss'] for d in\n"
    "          ctx.catalog.get_documents('lm_t') if 'epochRecord' in d]\n"
    "call('POST', '/serve/lm_t', {'type': 'lm', 'maxSlots': 2,\n"
    "     'cacheLen': 512, 'temperature': 0.0})\n"
    "served = call('POST', '/serve/lm_t/predict',\n"
    "              {'prompt': spec['prompt'], 'maxNewTokens': 8})\n"
    "call('DELETE', '/serve/lm_t')\n"
    "ctx.close()\n"
    "stats = locks.witness_stats()\n"
    "print('witness ' + json.dumps({'enabled': stats['enabled'],\n"
    "      'mode': stats['mode'], 'violations': stats['violations'],\n"
    "      'samples': stats['samples'][:4],\n"
    "      'edges': len(locks.witness_edges()), 'losses': losses,\n"
    "      'tokens': served['tokens']}), flush=True)\n")


def _epoch2_profile(torch, fit) -> dict:
    """``fit(log_fn)``, a 2-epoch fit through the engine's feed, with a
    profiler window over its second epoch alone (started and stopped by
    the epoch records; the first epoch pays the staging and first use):
    wall, device busy time, copies and idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def log_fn(record):
        if record["epoch"] == 0:
            prof.start()
            marks["t0"] = time.monotonic()
        else:
            torch.cuda.synchronize()
            marks["ms"] = (time.monotonic() - marks["t0"]) * 1e3
            prof.stop()

    fit(log_fn)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    copies_ms = sum(e.self_device_time_total for e in kernels
                    if "Memcpy" in e.key) / 1e3
    del prof, kernels
    gc.collect()
    return {"windowMs": marks["ms"], "deviceBusyMs": busy_ms,
            "memcpyMs": copies_ms, "idleShare": 1.0 - busy_ms / marks["ms"]}


# the engine's feeds of a fit that the featurePlane line compares, each
# (name, LO_SCAN_FIT_MAX_BYTES, LO_PREFETCH_BUFFER; None = the default):
# the staged epoch (the default under the budget), the prefetch thread
# (the default over it) and a copy in each step (the feed the staged
# fit replaced, kept for a fit with the prefetch thread off)
FEEDS = (("staged", None, None), ("prefetch", "0", None),
         ("perStep", "0", "0"))


def _set_feed(limit, buffer) -> None:
    for key, value in (("LO_SCAN_FIT_MAX_BYTES", limit),
                       ("LO_PREFETCH_BUFFER", buffer)):
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value


def _feed_runs(torch, attn, make, fit, profile_fit, feeds=FEEDS[:2]):
    """``make()`` a model and its batcher from one init and ``fit(model,
    log_fn)`` it through each of ``feeds`` in turn, every run through
    ``Engine.fit``'s loop: each run's seconds, launches and history, then
    ``profile_fit(model, log_fn)``, a further fit of the same model with
    its second epoch profiled (a few steps: the profiler's CPU events
    take seconds to collect)."""
    runs = {}
    try:
        for mode, limit, buffer in feeds:
            _set_feed(limit, buffer)
            model, batcher = make()
            if model._get_engine()._should_stage(batcher) != \
                    (mode == "staged"):
                raise AssertionError(f"{mode}: the staging rule disagrees")
            torch.cuda.synchronize()
            _reset_launches(attn)
            t0 = time.monotonic()
            hist = fit(model, None)
            torch.cuda.synchronize()
            runs[mode] = {"fitSeconds": time.monotonic() - t0,
                          "launches": _launches(attn), "history": hist,
                          "model": model}
            runs[mode]["profileEpoch2"] = _epoch2_profile(
                torch, lambda log_fn: profile_fit(model, log_fn))
    finally:
        _set_feed(None, None)
    return runs


def _resnet_feeds(torch, np, attn) -> dict:
    """ResNet-50 (bf16, 224x224x3, batch 64) fitted 2 epochs of
    ``FP_RESNET_STEPS`` steps through each feed, in the order
    ``FP_RESNET_ORDER`` (each feed twice, first and last swapped, so a
    drift of the card's clock weighs on all alike): ms a step of the
    second epoch of each run and their mean, and the losses. The
    prefetch and per-step runs are forced off the staged path
    (``LO_SCAN_FIT_MAX_BYTES=0``); a batch is then fed as in a fit over
    the budget."""
    from learningorchestra_tpu_torch.models.neural import NeuralModel

    rng = np.random.default_rng(0)
    rows = RESNET_BATCH * FP_RESNET_STEPS
    rx = rng.standard_normal((rows, 224, 224, 3), dtype=np.float32)
    ry = rng.integers(0, 1000, rows).astype(np.int32)
    body = [{"kind": "resnet50"}, {"kind": "activation", "fn": "softmax"}]
    init = []
    feeds = {name: (limit, buffer) for name, limit, buffer in FEEDS}
    out = {"rows": rows, "batch": RESNET_BATCH,
           "batchBytes": int(rx[:RESNET_BATCH].nbytes + ry[:RESNET_BATCH]
                             .nbytes), "order": list(FP_RESNET_ORDER)}
    zero = dict.fromkeys(COUNTERS, 0)
    try:
        for mode in FP_RESNET_ORDER:
            _set_feed(*feeds[mode])
            net = NeuralModel(body, device="cuda")
            if not init:
                net._build_params(rx[:1])
                init.append(({k: v.detach().clone()
                              for k, v in net.params.items()},
                             {k: v.detach().clone()
                              for k, v in net.model_state.items()}))
            else:
                net.set_params(*init[0], input_shape=rx.shape[1:])
            torch.cuda.synchronize()
            _reset_launches(attn)
            hist = net.fit(rx, ry, batch_size=RESNET_BATCH, epochs=2).history
            if _launches(attn) != zero:
                raise AssertionError(f"ResNet-50 {mode}: {_launches(attn)}")
            run = out.setdefault(mode, {"stepMsEpoch2": [], "losses": []})
            run["stepMsEpoch2"].append(
                hist["epochSeconds"][-1] / FP_RESNET_STEPS * 1e3)
            run["losses"].append(hist["loss"])
            del net
            gc.collect()
    finally:
        _set_feed(None, None)
    base = out["staged"]["losses"][0]
    for mode, _, _ in FEEDS:
        run = out[mode]
        run["stepMsMean"] = sum(run["stepMsEpoch2"]) / len(
            run["stepMsEpoch2"])
        run["lossesBitEqualStaged"] = all(r == base for r in run["losses"])
        run["lossesMaxRelStaged"] = max(
            abs(a - b) / abs(b) for r in run["losses"]
            for a, b in zip(r, base))
        # cuDNN's convolution backward may sum in another order from run
        # to run: the feeds give the same batches (the LM and CNN checks),
        # here the bound is a sanity check of the rows each feed sends
        if not all(np.isfinite(r).all() for r in run["losses"]) or \
                run["lossesMaxRelStaged"] > 1e-2:
            raise AssertionError(f"ResNet-50 {mode}: {run['losses']} vs "
                                 f"staged {base}")
    return out


def feature_plane_phase(torch, log, home, yard):
    """The feature plane on the card (the ``featurePlane`` line). (a) The
    tutorial LM's bf16 fit on the train phase's windows, staged (the
    padded epoch on the card once) and then through the prefetch feed
    (``LO_SCAN_FIT_MAX_BYTES=0``): losses equal bit for bit, 128 launches
    of each sm90 kernel each and nothing else, step time and the idle
    share of a profiled epoch each; with the train phase's losses in
    ``yard``, equal to them too. (b) The keras CNN at MNIST's shapes
    through those feeds and a copy in each step: losses within 1e-5
    relative (bit equality recorded), step time, samples/s and idle share
    each; ResNet-50 through the three feeds, ms a step. (c) Builder LR with
    ``meshParallel`` on 25,000 x 16 rows, twice on the same versions: the
    second run hits the arena and the feature cache for both datasets,
    reads no table from the catalog and predicts the same; a write to the
    training dataset, and the next run misses, stages again and the old
    entry's bytes leave the arena. (d) ``$corpus`` read twice through the
    pipeline's resolver: the second read a host-tier hit. (f) A slot
    session's params pinned in the arena under X-ray ``serving-params``
    (not ``arena``), the pin gone after the delete. (h) ``/metrics``
    carries the ``featureCache`` and ``arena`` blocks and their series,
    moved by (c), (d) and (f). (e) A tokened staged fit cancelled
    mid-epoch: its pin drops and a second staged copy evicts it. (g) A
    child with the lock witness armed runs (a)'s REST fit and a serving
    round with no violation. Returns each path's kernel launches."""
    import numpy as np

    from learningorchestra_tpu_torch import client as lo_client
    from learningorchestra_tpu_torch import observability as obs
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.estimators import \
        LogisticRegressionJAX
    from learningorchestra_tpu_torch.models.neural import NeuralModel
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.observability import xray
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime import arena as arena_lib
    from learningorchestra_tpu_torch.runtime import engine as engine_lib
    from learningorchestra_tpu_torch.runtime import preempt
    from learningorchestra_tpu_torch.runtime.data import dataframe_to_arrays
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import RestServer

    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    phase_t0 = time.monotonic()
    out, paths, part_s = {}, {}, {}
    zero = dict.fromkeys(COUNTERS, 0)
    # (a) the tutorial LM, staged and through the prefetch feed
    t_part = time.monotonic()
    x = _successor_windows(np, TRAIN_WINDOWS, TRAIN_SEQ, seed=0)
    init = weights.params_from_flax(weights.init_params(LM_CONFIG, seed=0))
    steps = TRAIN_EPOCHS * TRAIN_WINDOWS // TRAIN_BATCH
    want = dict(zero, **dict.fromkeys(
        ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
        LM_CONFIG["n_layers"] * steps * TRAIN_ACCUM))

    def make_lm():
        lm = LanguageModel(**LM_CONFIG, device="cuda")
        lm.set_params(init)
        return lm, lm._batcher(x, TRAIN_BATCH, shuffle=True)

    def fit_lm(lm, log_fn, rows=TRAIN_WINDOWS):
        return lm.fit(x[:rows], batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                      grad_accum=TRAIN_ACCUM, log_fn=log_fn).history

    def profile_lm(lm, log_fn):
        return fit_lm(lm, log_fn, FP_PROFILE_STEPS * TRAIN_BATCH)

    # the profiler's first window in a process runs slow (its buffers):
    # one is taken and dropped before the measured ones
    _epoch2_profile(torch, lambda log_fn: profile_lm(make_lm()[0], log_fn))
    lm_runs = _feed_runs(torch, attn, make_lm, fit_lm, profile_lm)
    lm_out = {}
    for mode, run in lm_runs.items():
        hist = run["history"]
        paths[f"featurePlane{mode.capitalize()}"] = run["launches"]
        if run["launches"] != want:
            raise AssertionError(f"(a) {mode} fit launched "
                                 f"{run['launches']}, want {want}")
        lm_out[mode] = {
            "losses": hist["loss"], "fitSeconds": run["fitSeconds"],
            "epochSeconds": hist["epochSeconds"],
            "stepMs": hist["epochSeconds"][1] / (steps // TRAIN_EPOCHS)
            * 1e3, "profileEpoch2": run["profileEpoch2"]}
    losses = lm_out["staged"]["losses"]
    if lm_out["prefetch"]["losses"] != losses:
        raise AssertionError(f"(a) staged losses {losses} differ from the "
                             f"prefetch feed's "
                             f"{lm_out['prefetch']['losses']}")
    if not all(abs(a - b) <= 0.01 * b
               for a, b in zip(losses, CUDA_CORE_LOSSES)):
        raise AssertionError(f"(a) losses {losses} not within 1% of "
                             f"{CUDA_CORE_LOSSES}")
    lm_out["lossesBitEqual"] = True
    if yard.get("losses") is not None:
        lm_out["lossesEqualTrainPhase"] = losses == yard["losses"]
        if losses != yard["losses"]:
            raise AssertionError(f"(a) losses {losses} differ from the train "
                                 f"phase's {yard['losses']}")
    out["lm"] = lm_out
    served_lm = lm_runs["staged"]["model"]
    del lm_runs
    gc.collect()
    part_s["lm"] = time.monotonic() - t_part
    t_part = time.monotonic()

    # (b) the keras CNN at MNIST's shapes, both ways
    xc, yc = _mnist_like(np, MNIST_ROWS, seed=0)
    cnn_init = []

    def make_cnn():
        model = NeuralModel(TUTORIAL_CNN, device="cuda")
        if not cnn_init:
            model._build_params(model._coerce_x(xc))
            cnn_init.append(({k: v.detach().clone()
                              for k, v in model.params.items()},
                             {k: v.detach().clone()
                              for k, v in model.model_state.items()}))
        else:
            model.set_params(*cnn_init[0], input_shape=xc.shape[1:])
        return model, model._batcher(xc, yc, MNIST_BATCH, shuffle=True)

    def fit_cnn(m, log_fn, rows=MNIST_ROWS):
        return m.fit(xc[:rows], yc[:rows], batch_size=MNIST_BATCH,
                     epochs=MNIST_EPOCHS, log_fn=log_fn).history

    cnn_runs = _feed_runs(
        torch, attn, make_cnn, fit_cnn,
        lambda m, log_fn: fit_cnn(m, log_fn, 8 * FP_PROFILE_STEPS *
                                  MNIST_BATCH), FEEDS)
    cnn_steps = -(-MNIST_ROWS // MNIST_BATCH)
    cnn_out = {"rows": MNIST_ROWS, "batch": MNIST_BATCH,
               "epochs": MNIST_EPOCHS}
    for mode, run in cnn_runs.items():
        hist = run["history"]
        if run["launches"] != zero:
            raise AssertionError(f"(b) {mode} launched {run['launches']}")
        cnn_out[mode] = {
            "losses": hist["loss"], "fitSeconds": run["fitSeconds"],
            "stepMsEpoch2": hist["epochSeconds"][-1] / cnn_steps * 1e3,
            "samplesPerSecEpoch2": hist["samplesPerSecond"][-1],
            "profileEpoch2": run["profileEpoch2"]}
    paths["featurePlaneCnn"] = cnn_runs["staged"]["launches"]
    a_l = cnn_out["staged"]["losses"]
    for mode in ("prefetch", "perStep"):
        b_l = cnn_out[mode]["losses"]
        cnn_out[mode]["lossesBitEqualStaged"] = a_l == b_l
        cnn_out[mode]["lossesMaxRelStaged"] = max(
            abs(p - q) / abs(q) for p, q in zip(b_l, a_l))
        if cnn_out[mode]["lossesMaxRelStaged"] > 1e-5:
            raise AssertionError(f"(b) staged {a_l} vs {mode} {b_l}")
    out["cnn"] = cnn_out
    del cnn_runs, xc, yc
    gc.collect()
    part_s["cnn"] = time.monotonic() - t_part
    # (b) ResNet-50 through the three feeds: where a batch is large, the
    # prefetch thread's copy under the step is what it is for
    t_part = time.monotonic()
    out["resnet50"] = _resnet_feeds(torch, np, attn)
    part_s["resnet50"] = time.monotonic() - t_part

    # (g)'s child starts here and runs beside (c) to (f), which record
    # seconds but gate none: (a)'s REST fit and a serving round under the
    # lock witness
    windows = os.path.join(home, "windows.npy")
    np.save(windows, x)
    spec = {"config": LM_CONFIG, "prompt": [int(t) for t in x[1, :256]],
            "fit": {"x": "$corpus", "batch_size": TRAIN_BATCH,
                    "epochs": TRAIN_EPOCHS, "grad_accum": TRAIN_ACCUM}}
    env = dict(os.environ, LO_LOCK_WITNESS="1", LO_LOCK_WITNESS_MODE="count",
               LO_COMPUTE_DTYPE="bfloat16",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t_witness = time.monotonic()
    # its output goes to files: a pipe nobody reads until the end could
    # fill and stop it
    child_out = os.path.join(home, "witness.out")
    with open(child_out, "w") as out_f, \
            open(child_out + ".err", "w") as err_f:
        child = subprocess.Popen(
            [sys.executable, "-c", FP_WITNESS_CHILD,
             os.path.join(home, "wit"), windows, json.dumps(spec)],
            env=env, stdout=out_f, stderr=err_f)
    _CHILDREN.append(child)
    t_part = time.monotonic()

    ctx = ServiceContext(Config(home=os.path.join(home, "lo")),
                         device="cuda")
    server = RestServer(port=0, context=ctx).start()
    base = server.base_url
    client = lo_client.Context(base)
    arena = arena_lib.get_default_arena()
    reads = []
    read_table = ctx.catalog.read_table

    def counted_read(name, *a, **k):
        reads.append(name)
        return read_table(name, *a, **k)

    ctx.catalog.read_table = counted_read
    m0 = (ctx.features.stats(), arena.stats())
    try:
        # (c) Builder LR on FP_BUILDER_ROWS x 16 rows: cold, warm, then a
        # write
        xw, yw = _wide_data(np, WIDE_ROWS, seed=11)
        xt, yt = _wide_data(np, WIDE_TEST_ROWS, seed=12)
        xb, yb = xw[:FP_BUILDER_ROWS], yw[:FP_BUILDER_ROWS]
        for name, (xs, ys) in (("fpWide", (xb, yb)),
                               ("fpWideTest", (xt, yt))):
            columns = {f"f{i}": xs[:, i] for i in range(WIDE_FEATURES)}
            columns["label"] = ys
            _write_dataset(ctx, name, [columns])
        del xt, yt

        def builder_run(tag):
            _reset_launches(attn)
            del reads[:]
            fc0, ar0 = ctx.features.stats(), arena.stats()
            t0 = time.monotonic()
            uris = client.builder_sparkml.run_builder(
                "fpWide", "fpWideTest", FP_WIDE_MODELING, ["LR"],
                meshParallel=True, evaluationDatasetName="fpWideTest")
            name = uris[0].rsplit("/", 1)[1]
            ctx.jobs.wait(name, timeout=900)
            seconds = time.monotonic() - t0
            meta = client.builder_sparkml.metadata(name)
            if not meta.get("finished") or meta.get("engine") != "torch":
                raise AssertionError(f"(c) {tag} run: {meta}")
            fc1, ar1 = ctx.features.stats(), arena.stats()
            return {"jobSeconds": seconds, "fitTime": meta["fitTime"],
                    "accuracy": meta["accuracy"], "tableReads": list(reads),
                    "launches": _launches(attn),
                    "featureCache": {k: fc1[k] - fc0[k] for k in (
                        "hits", "misses", "invalidations")},
                    "arena": {k: ar1[k] - ar0[k] for k in (
                        "hits", "misses", "evictions", "invalidations")},
                    "arenaBytesInUse": ar1["bytesInUse"],
                    "arenaPins": ar1["pins"]}, \
                ctx.catalog.read_columns(name)["prediction"][1]

        cold, cold_pred = builder_run("cold")
        warm, warm_pred = builder_run("warm")
        if warm["tableReads"] or warm["featureCache"]["hits"] < 2 or \
                warm["featureCache"]["misses"] or \
                warm["arena"] != {"hits": 1, "misses": 0, "evictions": 0,
                                  "invalidations": 0} or \
                cold["arena"]["misses"] != 1 or warm["arenaPins"]:
            raise AssertionError(f"(c) the warm run: {warm}, cold {cold}")
        warm["predictionsEqual"] = bool(np.array_equal(cold_pred,
                                                       warm_pred))
        if not warm["predictionsEqual"]:
            raise AssertionError("(c) warm predictions differ from cold")
        # a write to the training dataset: the labels of its first rows
        flipped = yb.copy()
        flipped[:1000] = (flipped[:1000] + 1) % WIDE_CLASSES
        with ctx.catalog.dataset_writer("fpWide") as w:
            w.write_batch(dict({f"f{i}": xb[:, i]
                                for i in range(WIDE_FEATURES)},
                               label=flipped))
        written, _ = builder_run("written")
        if "fpWide" not in written["tableReads"] or \
                written["arena"]["misses"] != 1 or \
                written["arena"]["invalidations"] != 1 or \
                written["arenaBytesInUse"] != cold["arenaBytesInUse"]:
            raise AssertionError(f"(c) after the write: {written}")
        paths["featurePlaneBuilder"] = {
            k: cold["launches"][k] + warm["launches"][k] +
            written["launches"][k] for k in COUNTERS}
        if paths["featurePlaneBuilder"] != zero:
            raise AssertionError(f"(c) launched "
                                 f"{paths['featurePlaneBuilder']}")
        out["builder"] = {"rows": FP_BUILDER_ROWS,
                          "features": WIDE_FEATURES,
                          "cold": cold, "warm": warm, "written": written}
        part_s["builder"] = time.monotonic() - t_part
        t_part = time.monotonic()

        # (d) $corpus twice through the pipeline's resolver
        _write_dataset(ctx, "corpus", [{f"t{i}": x[:, i]
                                        for i in range(TRAIN_SEQ)}])
        corpus = []
        for _ in range(2):
            fc0 = ctx.features.stats()
            t0 = time.monotonic()
            feed = dataframe_to_arrays(
                ctx.params.resolve_value("$corpus"))["x"]
            seconds = time.monotonic() - t0
            fc1 = ctx.features.stats()
            if not np.array_equal(feed, x):
                raise AssertionError("(d) $corpus does not give the windows")
            corpus.append({"hostSeconds": seconds,
                           "hit": fc1["hits"] - fc0["hits"] == 1})
        if corpus[0]["hit"] or not corpus[1]["hit"]:
            raise AssertionError(f"(d) {corpus}")
        out["corpus"] = corpus

        # (f) a slot session pins its params in the arena
        t_part = time.monotonic()
        ctx.artifacts.save(served_lm, "fpLm", "train/tensorflow")
        ar0, owners0 = arena.stats(), xray.by_owner()
        status, body = _http(base, "POST", "/serve/fpLm", {
            "type": "lm", "maxSlots": 2, "cacheLen": 512,
            "temperature": 0.0})
        if status != 201:
            raise AssertionError(f"(f) create: {status} {body}")
        ar1, owners1 = arena.stats(), xray.by_owner()
        prompt = [int(t) for t in x[0, :256]]
        _reset_launches(attn)
        status, served = _http(base, "POST", "/serve/fpLm/predict",
                               {"prompt": prompt, "maxNewTokens": 8})
        paths["featurePlaneServe"] = _launches(attn)
        if status != 200 or len(served["tokens"]) != 8:
            raise AssertionError(f"(f) predict: {status} {served}")
        _http(base, "DELETE", "/serve/fpLm")
        ar2, owners2 = arena.stats(), xray.by_owner()
        pinned = ar1["bytesInUse"] - ar0["bytesInUse"]
        session = {
            "pinnedBytes": pinned, "pins": ar1["pins"] - ar0["pins"],
            "servingParamsBytes": owners1["serving-params"] -
            owners0["serving-params"],
            "arenaOwnerDelta": owners1["arena"] - owners0["arena"],
            "bytesInUseAfterDelete": ar2["bytesInUse"],
            "bytesInUseBefore": ar0["bytesInUse"],
            "servingParamsAfterDelete": owners2["serving-params"] -
            owners0["serving-params"]}
        if not pinned > 0 or session["pins"] != 1 or \
                session["servingParamsBytes"] != pinned or \
                session["arenaOwnerDelta"] != 0 or \
                ar2["bytesInUse"] != ar0["bytesInUse"] or \
                session["servingParamsAfterDelete"] != 0:
            raise AssertionError(f"(f) the session's pin: {session}")
        out["session"] = session
        part_s["session"] = time.monotonic() - t_part

        # (h) /metrics carries both blocks, moved by (c), (d) and (f)
        status, raw, _ = _raw(base, "/metrics")
        metrics = json.loads(raw)
        status_p, prom, _ = _raw(base, "/metrics?format=prometheus")
        prom = prom.decode()
        fc, ar = ctx.features.stats(), arena.stats()
        moved = {"featureCache": {k: metrics["featureCache"][k] - m0[0][k]
                                  for k in ("hits", "misses",
                                            "invalidations")},
                 "arena": {k: metrics["arena"][k] - m0[1][k]
                           for k in ("hits", "misses", "invalidations")}}
        want_moved = {
            "featureCache": {
                k: sum(r["featureCache"][k] for r in (cold, warm, written))
                + (k == "misses") + (k == "hits")
                for k in ("hits", "misses", "invalidations")},
            # (f)'s pin is a miss of its own
            "arena": {k: sum(r["arena"][k] for r in (cold, warm, written))
                      + (k == "misses")
                      for k in ("hits", "misses", "invalidations")}}
        series = {name: float(value) for name, value in re.findall(
            r"^(lo_(?:feature_cache|arena)_\w+) (\S+)$", prom, re.M)}
        want_series = {
            "lo_feature_cache_hits_total": fc["hits"],
            "lo_feature_cache_misses_total": fc["misses"],
            "lo_feature_cache_bytes_in_use": fc["bytesInUse"],
            "lo_arena_bytes_in_use": ar["bytesInUse"],
            "lo_arena_evictions_total": ar["evictions"],
            "lo_arena_hits_total": ar["hits"],
            "lo_arena_misses_total": ar["misses"]}
        out["metrics"] = {"moved": moved, "series": series}
        if status != 200 or status_p != 200 or moved != want_moved or \
                metrics["featureCache"] != fc or metrics["arena"] != ar or \
                series != want_series:
            raise AssertionError(f"(h) /metrics: {out['metrics']}, want "
                                 f"{want_moved}, {want_series}")
    finally:
        ctx.catalog.read_table = read_table
        server.stop()
        ctx.close()
    del served_lm

    # (e) a tokened staged fit cancelled mid-epoch, under a budget of one
    # staged copy: its pin drops, and the next copy evicts it
    t_part = time.monotonic()
    obs.set_config(Config(home=os.path.join(home, "lo"),
                          arena_bytes=FP_EVICT_BUDGET))
    arena = arena_lib.get_default_arena()
    token, stepped = preempt.CancelToken(), []
    real_step = engine_lib.Engine._train_step_body

    def cancelling_step(self, *a, **k):
        stepped.append(1)
        if len(stepped) == FP_CANCEL_AT_STEP:
            token.cancel("cancelled")
        return real_step(self, *a, **k)

    lr = LogisticRegressionJAX(device="cuda")
    lr.feature_token, lr.feature_tags = ("fpCancel",), ("fpWide",)
    engine_lib.Engine._train_step_body = cancelling_step
    preempt.install_cancel(token)
    cancelled = False
    try:
        lr.fit(xw, yw)
    except preempt.JobCancelled:
        cancelled = True
    finally:
        engine_lib.Engine._train_step_body = real_step
        preempt.clear_cancel()
    after_cancel = arena.stats()
    cancelled_at = len(stepped)
    # the same through the prefetch feed, whose producer stops on the
    # cancel: the fit raises, and no epoch record is made
    del stepped[:]
    token = preempt.CancelToken()
    records = []
    fed = LogisticRegressionJAX(device="cuda")
    engine_lib.Engine._train_step_body = cancelling_step
    os.environ["LO_SCAN_FIT_MAX_BYTES"] = "0"
    preempt.install_cancel(token)
    fed_cancelled = False
    real_fit = engine_lib.Engine.fit
    try:
        engine_lib.Engine.fit = lambda self, *a, **k: real_fit(
            self, *a, **dict(k, log_fn=records.append))
        fed.fit(xw, yw)
    except preempt.JobCancelled:
        fed_cancelled = True
    finally:
        engine_lib.Engine._train_step_body = real_step
        engine_lib.Engine.fit = real_fit
        os.environ.pop("LO_SCAN_FIT_MAX_BYTES", None)
        preempt.clear_cancel()
    prefetch_cancel = {"cancelled": fed_cancelled,
                       "steps": len(stepped), "records": len(records)}
    again = LogisticRegressionJAX(device="cuda", epochs=1)
    again.feature_token, again.feature_tags = ("fpAgain",), ("fpWide",)
    again.fit(xw[:WIDE_ROWS // 2], yw[:WIDE_ROWS // 2])
    after_evict = arena.stats()
    cancel = {"cancelledAtStep": cancelled_at,
              "stepsPerEpoch": -(-WIDE_ROWS // lr.batch_size),
              "afterCancel": after_cancel, "afterNextFit": after_evict,
              "prefetchFeed": prefetch_cancel}
    out["cancel"] = cancel
    obs.reset_config()
    if not fed_cancelled or prefetch_cancel["records"] or \
            prefetch_cancel["steps"] > FP_CANCEL_AT_STEP + 1:
        raise AssertionError(f"(e) the prefetch feed's cancel: {cancel}")
    if not cancelled or cancelled_at != FP_CANCEL_AT_STEP or \
            after_cancel["pins"] != 0 or after_cancel["entries"] != 1 or \
            after_evict["evictions"] != 1 or after_evict["entries"] != 1 \
            or after_evict["pins"] != 0:
        raise AssertionError(f"(e) the cancelled fit's pin: {cancel}")
    del xw, yw, lr, again
    arena_lib.reset_default_arena()
    gc.collect()
    part_s["cancel"] = time.monotonic() - t_part

    # (g) the witness child's result
    try:
        child.wait(timeout=600)
    finally:
        _stop_children()
    with open(child_out) as f:
        stdout = f.read()
    with open(child_out + ".err") as f:
        stderr = f.read()
    line = next((ln for ln in stdout.splitlines()
                 if ln.startswith("witness ")), None)
    if child.returncode != 0 or line is None:
        raise AssertionError(f"(g) the witness child failed "
                             f"({child.returncode}): {stderr[-3000:]}")
    witness = json.loads(line[len("witness "):])
    witness["childSeconds"] = part_s["witness"] = \
        time.monotonic() - t_witness
    witness["lossesEqualStaged"] = witness["losses"] == losses
    out["witness"] = witness
    if not witness["enabled"] or witness["violations"] != 0 or \
            not witness["lossesEqualStaged"]:
        raise AssertionError(f"(g) witness: {witness}")
    out["seconds"] = part_s
    out["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("featurePlane " + json.dumps(out))
    return paths


# ----------------------------------------------------------------------
# the process group: NCCL, ring and Ulysses, pods of entry points
# ----------------------------------------------------------------------
# (b)'s shape, the training path's: b 8, 2048 tokens, 8 heads over 4,
# head_dim 64, causal with window 1024, split into DIST_RANKS blocks
DIST_SHAPE = dict(b=8, s=2048, h=8, kvh=4, d=64, window=1024)
DIST_RANKS = 4
# (c)'s fits: one epoch of 16 windows, batch 8 (2 optimizer steps)
DIST_FIT_WINDOWS, DIST_FIT_BATCH = 16, 8
# (b)'s sharded first steps: 2 windows of 2048 tokens in float32
DIST_GRAD_WINDOWS = 2
DIST_HEARTBEAT = 0.25
# (b)'s bf16 gate: each tensor's relative L2 to the float32 whole-sequence
# kernel at most this multiple of the bf16 whole-sequence kernel's
DIST_BF16_GAP_RATIO = 2.0
# (b)'s cases: name -> (impl, dtype, causal)
DIST_OP_CASES = {"ringCausalFloat32": ("ring", "float32", True),
                 "ringCausalBfloat16": ("ring", "bfloat16", True),
                 "ringFullBfloat16": ("ring", "bfloat16", False),
                 "ulyssesCausalFloat32": ("ulysses", "float32", True),
                 "ulyssesCausalBfloat16": ("ulysses", "bfloat16", True)}
# (b)'s sharded LM steps: name -> (mesh over ranks 0 and 1, attention)
DIST_GRAD_CASES = {"dp2": ("dp=2", "flash"), "sp2Ring": ("sp=2", "ring"),
                   "sp2Ulysses": ("sp=2", "ulysses")}
# (e)'s model-parallel first steps: name -> (mesh, "lm" or "moe")
DIST_MODEL_CASES = {"tp2": ("tp=2", "lm"), "fsdp2Tp2": ("fsdp=2,tp=2", "lm"),
                    "dp2Tp2": ("dp=2,tp=2", "lm"),
                    "moeEp2Tp2": ("ep=2,tp=2", "moe"),
                    "moeDp2": ("dp=2", "moe")}
# (f)'s pipelined LM at the tutorial's widths: 4 windows of 2048 tokens,
# 4 microbatches, float32, flash attention with window 1024
DIST_PP = dict(vocab=32000, d=512, layers=8, heads=8, d_ff=2048,
               windows=4, seq=2048, window=1024, microbatches=4)
DIST_PP_CASES = {"pp2Gpipe": ("pp=2", "gpipe"), "pp2OneFOneB": ("pp=2", "1f1b"),
                 "pp4Gpipe": ("pp=4", "gpipe"), "pp4OneFOneB": ("pp=4", "1f1b")}

DIST_RANK = (
    "import datetime, json, os, sys, time\n"
    "import numpy as np\n"
    "import torch\n"
    "from learningorchestra_tpu_torch.models import weights\n"
    "from learningorchestra_tpu_torch.models import pp_transformer as pp\n"
    "from learningorchestra_tpu_torch.models.transformer import "
    "LanguageModel\n"
    "from learningorchestra_tpu_torch.parallel import sharding\n"
    "from learningorchestra_tpu_torch.ops import attention as attn\n"
    "from learningorchestra_tpu_torch.parallel import ring, ulysses\n"
    "from learningorchestra_tpu_torch.runtime import data\n"
    "from learningorchestra_tpu_torch.runtime import distributed as dist\n"
    "from learningorchestra_tpu_torch.runtime import mesh as mesh_lib\n"
    "rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]\n"
    "spec = json.loads(sys.argv[4])\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "t0 = time.monotonic()\n"
    "assert dist.initialize('127.0.0.1:' + port, world, rank, "
    "device='cuda', timeout=datetime.timedelta(seconds=120))\n"
    "sh = spec['shape']\n"
    "b, s, h, kvh, d, W = (sh[k] for k in ('b', 's', 'h', 'kvh', 'd', "
    "'window'))\n"
    "cols = slice(rank * s // world, (rank + 1) * s // world)\n"
    "mesh = mesh_lib.build_mesh('sp=%d' % world)\n"
    "def inputs(dtype):\n"
    "    g = torch.Generator().manual_seed(11)\n"
    "    q = torch.randn(b, s, h, d, generator=g)\n"
    "    k = torch.randn(b, s, kvh, d, generator=g) * 0.5\n"
    "    v = torch.randn(b, s, kvh, d, generator=g)\n"
    "    do = torch.randn(b, s, h, d, generator=g)\n"
    "    return [t.to('cuda', dtype) for t in (q, k, v, do)]\n"
    "def whole(q, k, v, do, causal):\n"
    "    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))\n"
    "    o = attn.flash_attention(q, k, v, causal=causal,\n"
    "                             window=W if causal else 0)\n"
    "    (o.float() * do.float()).sum().backward()\n"
    "    return [o.detach(), q.grad, k.grad, v.grad]\n"
    "def gaps(got, want):\n"
    "    # per tensor relative L2 over the whole sequence: squared sums\n"
    "    # of this rank's block, summed over the ranks\n"
    "    sums = []\n"
    "    for a, w in zip(got, want):\n"
    "        w = w[:, cols].float()\n"
    "        sums += [((a.float() - w) ** 2).sum(), (w ** 2).sum()]\n"
    "    t = dist.all_reduce(torch.stack(sums).double().cpu())\n"
    "    return [float((t[i] / t[i + 1]).sqrt())\n"
    "            for i in range(0, len(t), 2)]\n"
    "out = {'startSeconds': time.monotonic() - t0, 'ops': {}}\n"
    "dist.reset_staged_bytes()\n"
    "for name, (impl, dtype, causal) in spec['ops'].items():\n"
    "    dt = getattr(torch, dtype)\n"
    "    q, k, v, do = inputs(dt)\n"
    "    ref32 = whole(*inputs(torch.float32), causal)\n"
    "    ref = ref32 if dt == torch.float32 else whole(q, k, v, do, causal)\n"
    "    torch.cuda.synchronize()\n"
    "    staged0 = dist.staged_bytes()\n"
    "    before = attn.launch_counts()\n"
    "    ql, kl, vl = (t[:, cols].contiguous().requires_grad_()\n"
    "                  for t in (q, k, v))\n"
    "    win = W if causal else 0\n"
    "    if impl == 'ring':\n"
    "        kr = torch.repeat_interleave(kl, h // kvh, dim=2)\n"
    "        vr = torch.repeat_interleave(vl, h // kvh, dim=2)\n"
    "        o = ring.ring_attention_sharded(ql, kr, vr, mesh,\n"
    "                                        causal=causal, window=win)\n"
    "    else:\n"
    "        o = ulysses.ulysses_attention_sharded(\n"
    "            ql, kl, vl, mesh, causal=causal, window=win)\n"
    "    (o.float() * do[:, cols].float()).sum().backward()\n"
    "    torch.cuda.synchronize()\n"
    "    after = attn.launch_counts()\n"
    "    staged = dist.staged_bytes()\n"
    "    got = [o.detach(), ql.grad, kl.grad, vl.grad]\n"
    "    out['ops'][name] = {\n"
    "        'launches': {k_: after[k_] - before[k_] for k_ in after},\n"
    "        'relL2VsWhole': dict(zip(('o', 'dq', 'dk', 'dv'),\n"
    "                                 gaps(got, ref))),\n"
    "        'relL2VsWholeFloat32': dict(zip(('o', 'dq', 'dk', 'dv'),\n"
    "                                        gaps(got, ref32))),\n"
    "        'wholeRelL2VsFloat32': dict(zip(('o', 'dq', 'dk', 'dv'),\n"
    "                                        gaps([t[:, cols] for t in ref],\n"
    "                                             ref32))),\n"
    "        'stagedBytes': {k_: staged[k_] - staged0[k_] for k_ in staged}}\n"
    "# (b') the tutorial LM's first float32 step, sharded over ranks 0 and\n"
    "# 1, against the one-rank step on rank 0\n"
    "os.environ['LO_COMPUTE_DTYPE'] = 'float32'\n"
    "out['grads'] = {}\n"
    "x = np.asarray(spec['windows'], np.int32)\n"
    "batch = {'x': x, data.MASK_KEY: np.ones(len(x), np.float32)}\n"
    "tree = weights.params_from_flax(weights.init_params(spec['config'], "
    "seed=0))\n"
    "def model(attention):\n"
    "    lm = LanguageModel(**spec['config'], attention=attention,\n"
    "                       device='cuda')\n"
    "    lm.set_params(tree)\n"
    "    return lm, lm._get_engine()\n"
    "reference = None\n"
    "if rank == 0:\n"
    "    lm, eng = model('flash')\n"
    "    state = eng.init_state(lm._master_params())\n"
    "    g, _, m = eng._step_grads(state, eng._to_device(batch, 'cuda'), 0)\n"
    "    reference = {k_: t.detach().clone() for k_, t in g.items()}\n"
    "    out['gradsLoss'] = float(m['loss'][0] / m['loss'][1])\n"
    "    del lm, eng, state, g\n"
    "for name, (mesh_spec, attention) in spec['grads'].items():\n"
    "    gmesh = mesh_lib.build_mesh(mesh_spec)\n"
    "    if gmesh.coords(rank) is None:\n"
    "        gmesh.form_groups()\n"
    "        continue\n"
    "    lm, eng = model(attention)\n"
    "    lm._mesh_override = gmesh\n"
    "    state = eng.init_state(lm._master_params())\n"
    "    shard, columns = lm._plan(x.shape[1])\n"
    "    before = attn.launch_counts()\n"
    "    staged0 = dist.staged_bytes()\n"
    "    g, m = eng.sharded_grads(state, batch, 0, shard, columns)\n"
    "    torch.cuda.synchronize()\n"
    "    after = attn.launch_counts()\n"
    "    staged = dist.staged_bytes()\n"
    "    rec = {'launches': {k_: after[k_] - before[k_] for k_ in after},\n"
    "           'loss': float(m['loss'][0] / m['loss'][1]),\n"
    "           'seqParallel': shard.seq_size > 1,\n"
    "           'gradBytes': sum(4 * t.numel() for t in g.values()),\n"
    "           'stagedBytes': {k_: staged[k_] - staged0[k_]\n"
    "                           for k_ in staged}}\n"
    "    if reference is not None:\n"
    "        rel = {k_: float(\n"
    "            (t.float() - reference[k_].float()).norm()\n"
    "            / reference[k_].float().norm().clamp_min(1e-30))\n"
    "               for k_, t in g.items()}\n"
    "        worst = max(rel, key=rel.get)\n"
    "        rec['relL2VsOneRank'] = {'max': rel[worst], 'worst': worst}\n"
    "    out['grads'][name] = rec\n"
    "    del lm, eng, state, g\n"
    "def rel_l2(got, want):\n"
    "    rel = {k_: float((got[k_].float() - want[k_].float()).norm()\n"
    "                     / want[k_].float().norm().clamp_min(1e-30))\n"
    "           for k_ in want}\n"
    "    worst = max(rel, key=rel.get)\n"
    "    return {'max': rel[worst], 'worst': worst}\n"
    "# (e) tensor, fully-sharded and expert parallelism: the first float32\n"
    "# step of the tutorial LM and its MoE, every rank its shards\n"
    "out['model'] = {}\n"
    "moe_tree = weights.params_from_flax(weights.init_params(\n"
    "    spec['moeConfig'], seed=0))\n"
    "moe_reference = None\n"
    "if rank == 0:\n"
    "    lm = LanguageModel(**spec['moeConfig'], attention='flash',\n"
    "                       device='cuda')\n"
    "    lm.set_params(moe_tree)\n"
    "    eng = lm._get_engine()\n"
    "    state = eng.init_state(lm._master_params())\n"
    "    g, _, m = eng._step_grads(state, eng._to_device(batch, 'cuda'), 0)\n"
    "    moe_reference = {k_: t.detach().clone() for k_, t in g.items()}\n"
    "    out['moeLoss'] = float(m['loss'][0] / m['loss'][1])\n"
    "    del lm, eng, state, g\n"
    "for name, (mesh_spec, kind) in spec['model'].items():\n"
    "    gmesh = mesh_lib.build_mesh(mesh_spec)\n"
    "    if gmesh.coords(rank) is None:\n"
    "        gmesh.form_groups()\n"
    "        continue\n"
    "    config = spec['moeConfig'] if kind == 'moe' else spec['config']\n"
    "    lm = LanguageModel(**config, attention='flash', device='cuda')\n"
    "    lm.set_params(moe_tree if kind == 'moe' else tree)\n"
    "    lm._mesh_override = gmesh\n"
    "    eng = lm._get_engine()\n"
    "    shard, columns = lm._plan(x.shape[1])\n"
    "    layout = lm._layout(shard)\n"
    "    state = eng.init_state(lm._master_params(), layout=layout)\n"
    "    # the bytes of this rank's shard of every leaf by the layout\n"
    "    want_bytes = sum(4 * int(np.prod(sharding.local_shape(\n"
    "        tuple(p.shape), layout.specs[k_], gmesh)))\n"
    "        for k_, p in lm._master_params().items()) if layout else \\\n"
    "        sum(4 * p.numel() for p in lm._master_params().values())\n"
    "    param_bytes = sum(t.numel() * t.element_size()\n"
    "                      for t in state.params.values())\n"
    "    opt_bytes = sum(t.numel() * t.element_size()\n"
    "                    for slot in ('mu', 'nu')\n"
    "                    for t in state.opt_state[slot].values())\n"
    "    torch.cuda.synchronize()\n"
    "    before = attn.launch_counts()\n"
    "    staged0 = dist.staged_bytes()\n"
    "    g, m = eng.sharded_grads(state, batch, 0, shard, columns)\n"
    "    torch.cuda.synchronize()\n"
    "    after = attn.launch_counts()\n"
    "    staged = dist.staged_bytes()\n"
    "    whole = layout.gather(g) if layout is not None else g\n"
    "    rec = {'launches': {k_: after[k_] - before[k_] for k_ in after},\n"
    "           'loss': float(m['loss'][0] / m['loss'][1]),\n"
    "           'paramBytes': param_bytes, 'specBytes': want_bytes,\n"
    "           'adamBytes': opt_bytes,\n"
    "           'stagedBytes': {k_: staged[k_] - staged0[k_]\n"
    "                           for k_ in staged}}\n"
    "    ref = moe_reference if kind == 'moe' else reference\n"
    "    if ref is not None:\n"
    "        rec['relL2VsOneRank'] = rel_l2(whole, ref)\n"
    "    out['model'][name] = rec\n"
    "    del lm, eng, state, g, whole\n"
    "# (f) the pipelined LM at full width: GPipe and 1F1B at pp=2 and pp=4\n"
    "P = spec['pp']\n"
    "pp_tokens = np.random.default_rng(5).integers(\n"
    "    1, P['vocab'], size=(P['windows'], P['seq'])).astype(np.int32)\n"
    "params = pp.init_params(0, P['vocab'], P['d'], P['layers'],\n"
    "                        P['d_ff'], device='cuda')\n"
    "def leaves():\n"
    "    return [params['embed']] + [params['blocks'][k_]\n"
    "                               for k_ in pp.BLOCK_KEYS]\n"
    "names = ['embed'] + ['blocks/' + k_ for k_ in pp.BLOCK_KEYS]\n"
    "for t in leaves():\n"
    "    t.requires_grad_(True)\n"
    "out['pp'] = {}\n"
    "pp_reference = None\n"
    "if rank == 0:\n"
    "    loss = pp.next_token_loss(params, pp_tokens, None, P['heads'],\n"
    "                              attention='flash', window=P['window'])\n"
    "    pp_reference = dict(zip(names, torch.autograd.grad(loss,\n"
    "                                                       leaves())))\n"
    "    out['ppLoss'] = float(loss)\n"
    "for name, (mesh_spec, schedule) in spec['ppCases'].items():\n"
    "    gmesh = mesh_lib.build_mesh(mesh_spec)\n"
    "    if gmesh.coords(rank) is None:\n"
    "        gmesh.form_groups()\n"
    "        continue\n"
    "    torch.cuda.synchronize()\n"
    "    before = attn.launch_counts()\n"
    "    staged0 = dist.staged_bytes()\n"
    "    if schedule == 'gpipe':\n"
    "        loss = pp.next_token_loss(\n"
    "            params, pp_tokens, gmesh, P['heads'],\n"
    "            num_microbatches=P['microbatches'], attention='flash',\n"
    "            window=P['window'])\n"
    "        got = torch.autograd.grad(loss, leaves())\n"
    "    else:\n"
    "        loss, grads = pp.value_and_grad_1f1b(\n"
    "            params, pp_tokens, gmesh, P['heads'],\n"
    "            num_microbatches=P['microbatches'], attention='flash',\n"
    "            window=P['window'])\n"
    "        got = [grads['embed']] + [grads['blocks'][k_]\n"
    "                                  for k_ in pp.BLOCK_KEYS]\n"
    "    torch.cuda.synchronize()\n"
    "    after = attn.launch_counts()\n"
    "    staged = dist.staged_bytes()\n"
    "    if schedule == 'gpipe':\n"
    "        # each stage's block gradients are its own rows: their sum\n"
    "        # over pp is the whole gradient\n"
    "        group = mesh_lib.Shard(gmesh, rank, False).pp_group\n"
    "        got = [got[0]] + [dist.all_reduce(t.clone(), group)\n"
    "                          for t in got[1:]]\n"
    "    rec = {'launches': {k_: after[k_] - before[k_] for k_ in after},\n"
    "           'loss': float(loss),\n"
    "           'stagedBytes': {k_: staged[k_] - staged0[k_]\n"
    "                           for k_ in staged}}\n"
    "    if pp_reference is not None:\n"
    "        rec['relL2VsOneRank'] = rel_l2(dict(zip(names, got)),\n"
    "                                       pp_reference)\n"
    "    out['pp'][name] = rec\n"
    "    del got, loss\n"
    "out['hostInfo'] = dist.host_info('cuda')\n"
    "out['seconds'] = time.monotonic() - t0\n"
    "dist.barrier()\n"
    "dist.shutdown()\n"
    "print('rank ' + json.dumps(out), flush=True)\n")


def _rank_launches(counts: dict) -> dict:
    """A launch record keyed as ``COUNTERS`` (the engine's and the
    ranks' records name every source)."""
    return {name: int(counts.get(name, 0)) for name in COUNTERS}


def _sm90(n: int) -> dict:
    return dict(dict.fromkeys(COUNTERS, 0), flash_fwd_sm90=n,
                flash_bwd_dq_sm90=n, flash_bwd_dkv_sm90=n)


def _tf32x3(n: int) -> dict:
    return dict(dict.fromkeys(COUNTERS, 0), flash_fwd_tf32x3=n,
                flash_bwd_dq_tf32x3=n, flash_bwd_dkv_tf32x3=n)


def _ring_hops(ranks: int, local: int, window: int, causal: bool) -> list:
    """The hops each rank of a ring attends: the distances d >= 0 with
    ``d·local < window + local - 1`` (all of them without a window;
    every hop when not causal)."""
    if not causal:
        return [ranks] * ranks
    return [sum(1 for dist_ in range(r + 1)
                if not window or dist_ * local < window + local - 1)
            for r in range(ranks)]


def _staged_rank0(base: str) -> dict:
    """The pod coordinator's bytes staged through host memory so far."""
    return _wait_health(base, lambda h: "stagedBytes" in h)["stagedBytes"]


def _health_launches(base: str) -> dict:
    """The pod coordinator's flash-kernel launches so far."""
    return _rank_launches(_wait_health(
        base, lambda h: "kernelLaunches" in h)["kernelLaunches"])


def _wait_health(base: str, want, timeout: float = 300.0) -> dict:
    """``/health`` once ``want(body)`` holds."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(base + "/health", timeout=5) as r:
                last = json.loads(r.read())
            if want(last):
                return last
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"{base}/health never matched: {last}")


def _whole_tree_check(np, home: str, name: str) -> dict:
    """(g): the trained artifact ``name``'s ``weights.msgpack`` holds
    every leaf of the tutorial LM's flax tree at its whole shape."""
    import glob

    from learningorchestra_tpu_torch.models import weights
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.runtime import serialization

    found = glob.glob(os.path.join(home, "artifacts", "**", name, "**",
                                   "weights.msgpack"), recursive=True)
    if len(found) != 1:
        raise AssertionError(f"(g) the artifact {name}: {found}")
    path = found[0]
    with open(path, "rb") as f:
        saved = serialization.msgpack_restore(f.read())["params"]

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, prefix + k + "/"))
            else:
                out[prefix + k] = tuple(np.shape(v))
        return out

    got = shapes(saved)
    model = LanguageModel(**LM_CONFIG, device="cpu")
    want = shapes(weights.params_to_flax(
        model._new_module().state_dict(),
        lambda t, transposed: t.t() if transposed else t))
    if got != want:
        raise AssertionError(f"(g) {path}: {got} against the whole tree "
                             f"{want}")
    return {"leaves": len(got), "embed": list(got["embed/embedding"]),
            "lmHead": list(got["lm_head/kernel"])}


def _model_parallel_checks(results, layers: int) -> dict:
    """(e): every rank's loss the same, every gradient within per-tensor
    relative L2 1e-4 of the one-rank step's, each rank's params and
    AdamW moments exactly the shards its layout gives it (the engine
    held to the layout; the layout's shapes are held to the JAX
    ``NamedSharding``'s in tests/test_torch_model_parallel.py), one
    launch a layer of each split-TF32 kernel on every rank (the flash
    kernel on its local heads)."""
    out = {}
    for name, (mesh_spec, kind) in DIST_MODEL_CASES.items():
        per_rank = [r["model"][name] for r in results
                    if name in r["model"]]
        launches = [_rank_launches(p["launches"]) for p in per_rank]
        rel = per_rank[0]["relL2VsOneRank"]
        if launches != [_tf32x3(layers)] * len(per_rank) or \
                rel["max"] > 1e-4 or \
                len({p["loss"] for p in per_rank}) != 1 or any(
                    p["paramBytes"] != p["specBytes"] or
                    p["adamBytes"] != 2 * p["specBytes"]
                    for p in per_rank):
            raise AssertionError(f"(e) {name}: launches {launches}, {rel}, "
                                 f"{per_rank}")
        out[name] = {"mesh": mesh_spec, "kind": kind,
                     "f32GradRelL2VsOneRank": rel,
                     "loss": per_rank[0]["loss"],
                     "oneRankLoss": results[0]["moeLoss" if kind == "moe"
                                               else "gradsLoss"],
                     "paramBytesByRank": [p["paramBytes"] for p in per_rank],
                     "adamBytesByRank": [p["adamBytes"] for p in per_rank],
                     "launchesByRank": launches,
                     "stagedBytesByRank": [p["stagedBytes"]
                                           for p in per_rank]}
    return out


def _pipeline_checks(results) -> dict:
    """(f): the pipelined LM's loss and every gradient within 1e-4 of the
    one-rank sequential step on every stage, and each stage's launches
    exactly its layers times the microbatches of each split-TF32
    kernel."""
    out = {}
    per_stage = DIST_PP["layers"] * DIST_PP["microbatches"]
    for name, (mesh_spec, schedule) in DIST_PP_CASES.items():
        per_rank = [r["pp"][name] for r in results if name in r["pp"]]
        n = len(per_rank)
        launches = [_rank_launches(p["launches"]) for p in per_rank]
        rel = per_rank[0]["relL2VsOneRank"]
        loss0 = results[0]["ppLoss"]
        if launches != [_tf32x3(per_stage // n)] * n or \
                rel["max"] > 1e-4 or any(
                    abs(p["loss"] - loss0) > 1e-4 * abs(loss0)
                    for p in per_rank):
            raise AssertionError(f"(f) {name}: launches {launches}, {rel}, "
                                 f"losses {[p['loss'] for p in per_rank]} "
                                 f"against {loss0}")
        out[name] = {"mesh": mesh_spec, "schedule": schedule,
                     "f32GradRelL2VsOneRank": rel,
                     "lossByStage": [p["loss"] for p in per_rank],
                     "oneRankLoss": loss0, "launchesByStage": launches,
                     "stagedBytesByStage": [p["stagedBytes"]
                                            for p in per_rank]}
    return out


def distributed_phase(torch, log, home, yard):
    """The process group on the card (the ``distributed`` line). (a) A
    world of one on NCCL: ``all_reduce``, ``broadcast`` and ``barrier``
    on CUDA tensors, ``host_info``. (b) Four gloo ranks sharing the card
    (NCCL refuses two ranks on one device): the ring and Ulysses at the
    training shape (b 8, 2048 tokens, 8 over 4 heads, d 64), causal with
    window 1024 in float32 (split TF32) and bf16 (sm90), and the
    non-causal ring in bf16; forward o and the q/k/v gradients against
    the whole-sequence kernel on one rank (float32 per-tensor relative
    L2 <= 1e-4; bf16 each tensor's gap to the float32 whole-sequence
    kernel within ``DIST_BF16_GAP_RATIO`` times the bf16 whole kernel's),
    exact launches per rank (the causal ring 1, 2, 3, 3: the hop at
    distance 3 lies below the band), the bytes staged through the host;
    and the tutorial LM's first float32 step at dp=2, sp=2 ring and sp=2
    Ulysses on ranks 0 and 1, every gradient within per-tensor relative
    L2 1e-4 of the one-rank step's, the gradient all-reduce's bytes
    counted through the host. (c) Two pods of two ranks of the port's
    entry point under ``cluster.py``'s supervisor: a bf16 REST fit (one
    epoch of 16 windows, batch 8) at ``LO_MESH_SHAPE=dp=2``, then ring
    and Ulysses fits at ``sp=2``: losses within 1% of the one-rank fit
    of the same batches, each rank's launches (the epoch record's
    ``launchesByRank``) exactly the path's, sm90 only, rank 0's staged
    bytes at least each step's gradient all-reduce; then a REST evaluate
    of the ring model, exactly one whole-sequence forward launch a layer
    for each batch on rank 0 (``/health`` ``kernelLaunches``). (d) A
    member SIGKILLed mid-fit: the job's typed ``WorkerLost`` document
    and ``/health``'s ``podFailure`` within the heartbeat bound, then
    the supervisor's restart. (e) In (b)'s ranks, the tutorial LM's
    float32 first step at tp=2, fsdp=2,tp=2 and dp=2,tp=2, and its MoE's
    (8 experts, k 2) at ep=2,tp=2 and dp=2 (the mesh-wide routing):
    every gradient within per-tensor relative L2 1e-4 of the one-rank
    step, the same loss on every rank, each rank's params and AdamW bytes
    exactly the shards its layout gives it, 8 launches of each split-TF32
    kernel a rank (the kernel on its local heads), the staged bytes
    recorded. (f) In the same ranks, the pipelined LM (``DIST_PP``:
    vocab 32000, d 512, 8 layers, 8 heads, d_ff 2048, 4 windows of 2048
    tokens, window 1024, flash, float32) by GPipe and 1F1B at pp=2 and
    pp=4, 4 microbatches: loss and gradients within 1e-4 of the one-rank
    sequential step, each stage's launches its layers times the
    microbatches of each kernel, the bytes between stages recorded. (g)
    A third pod at ``LO_MESH_SHAPE=tp=2``: the bf16 REST fit as (c)'s,
    launches exact, the trained artifact's ``weights.msgpack`` every
    leaf at its whole flax shape. The three pods fit at once, each
    pod's fits one after the other. Returns the pods' fits' launches,
    summed over ranks."""
    import numpy as np

    from learningorchestra_tpu_torch.cluster import PodSupervisor
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.models.transformer import \
        LanguageModel
    from learningorchestra_tpu_torch.ops import attention as attn
    from learningorchestra_tpu_torch.runtime import distributed as dist
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.services.server import Api

    phase_t0 = time.monotonic()
    os.environ["LO_COMPUTE_DTYPE"] = "bfloat16"
    # the ranks and pods below share the card with this process
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    out: dict = {}
    x = _successor_windows(np, DIST_FIT_WINDOWS, TRAIN_SEQ, seed=0)

    def free_port():
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    # the pods' homes: the corpus and the three models, made here
    pods = {"dp": ("dp=2", {"lm_dp": "flash"}),
            "sp": ("sp=2", {"lm_ring": "ring", "lm_ulysses": "ulysses"}),
            "tp": ("tp=2", {"lm_tp": "flash"})}
    for key, (_, models) in pods.items():
        ctx = ServiceContext(Config(home=os.path.join(home, key)),
                             device="cuda")
        try:
            _save_arrays(ctx, "corpus", {"tokens": x})
            api = Api(ctx)
            for name, attention in models.items():
                api.dispatch("POST", PREFIX + "/model/tensorflow", {}, {
                    "modelName": name,
                    "modulePath": "learningorchestra_tpu_torch.models",
                    "class": "LanguageModel",
                    "classParameters": dict(LM_CONFIG,
                                            attention=attention)})
                ctx.jobs.wait(name, timeout=600)
        finally:
            ctx.close()
    gc.collect()
    env = {"PYTHONPATH": root, "LO_COMPUTE_DTYPE": "bfloat16",
           "LO_HEARTBEAT_INTERVAL": str(DIST_HEARTBEAT), "LO_MONITOR": "0"}
    sups, threads, codes = {}, [], {}
    t_pods = time.monotonic()
    for key, (mesh_spec, _) in pods.items():
        sup = PodSupervisor(
            hosts=2, port=free_port(), home=os.path.join(home, key),
            backoff=0.5, max_restarts=2, device="cuda",
            extra_env=dict(env, LO_MESH_SHAPE=mesh_spec))
        sup.start()
        sups[key] = sup
        thread = threading.Thread(
            target=lambda k=key, s=sup: codes.__setitem__(k, s.supervise()),
            daemon=True)
        thread.start()
        threads.append(thread)
    try:
        # (b)'s ranks start with the pods and end while they boot; their
        # output goes to files (a full pipe would stop a rank)
        spec = {"shape": DIST_SHAPE, "ops": DIST_OP_CASES,
                "grads": DIST_GRAD_CASES, "config": LM_CONFIG,
                "windows": x[:DIST_GRAD_WINDOWS].tolist(),
                "model": DIST_MODEL_CASES, "moeConfig": MOE_CONFIG,
                "pp": DIST_PP, "ppCases": DIST_PP_CASES}
        rank_port = str(free_port())
        rank_logs = [os.path.join(home, f"rank{r}")
                     for r in range(DIST_RANKS)]
        for r, path in enumerate(rank_logs):
            with open(path + ".out", "w") as out_f, \
                    open(path + ".err", "w") as err_f:
                _CHILDREN.append(subprocess.Popen(
                    [sys.executable, "-c", DIST_RANK, str(r),
                     str(DIST_RANKS), rank_port, json.dumps(spec)],
                    env=dict(os.environ, **env), stdout=out_f,
                    stderr=err_f))
        ranks = list(_CHILDREN[-DIST_RANKS:])

        # (a) a world of one on NCCL, in this process
        t0 = time.monotonic()
        if not dist.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                               device="cuda"):
            raise AssertionError("(a) no group formed")
        try:
            t = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
            want = t.clone()
            dist.all_reduce(t)
            b = torch.full((8,), 7, device="cuda")
            dist.broadcast(b, src=0)
            dist.barrier()
            torch.cuda.synchronize()
            info = dist.host_info("cuda")
            ok = bool(torch.equal(t, want)) and int(b.sum()) == 56
        finally:
            dist.shutdown()
        if info["backend"] != "nccl" or not ok or dist.is_initialized():
            raise AssertionError(f"(a) {info} {ok}")
        out["nccl"] = {"hostInfo": info, "collectivesEqual": ok,
                       "seconds": time.monotonic() - t0}

        # (c)'s yardstick: the one-rank fit of the same batches
        t0 = time.monotonic()
        lm = LanguageModel(**LM_CONFIG, device="cuda")
        reference = lm.fit(x, batch_size=DIST_FIT_BATCH, epochs=1).history
        # the bytes of one gradient all-reduce: the float32 gradients
        grad_bytes = sum(4 * t.numel() for t in lm._master_params().values())
        del lm
        gc.collect()
        out["oneRank"] = {"losses": reference["loss"],
                          "fitSeconds": time.monotonic() - t0}
        pod_out = {}
        for key, sup in sups.items():
            health = _wait_health(f"http://127.0.0.1:{sup.port}",
                                  lambda h: h.get("processCount") == 2)
            pod_out[key] = {"bootSeconds": time.monotonic() - t_pods,
                            "health": {k: health.get(k) for k in (
                                "status", "processCount", "globalDevices",
                                "localDevices", "backend", "platform")}}
            if (health["backend"], health["globalDevices"]) != ("gloo", 2):
                raise AssertionError(f"(c) {key} pod: {health}")

        # (c) the pods' fits
        steps = DIST_FIT_WINDOWS // DIST_FIT_BATCH
        layers = LM_CONFIG["n_layers"]
        sp_local = TRAIN_SEQ // 2
        # (g) at tp=2 each rank runs the kernels on its 4 of 8 heads,
        # once a layer a step
        fits = {"dp": {"lm_dp": [_sm90(layers * steps)] * 2},
                "sp": {"lm_ring": [_sm90(layers * steps * n) for n in
                                   _ring_hops(2, sp_local,
                                              LM_CONFIG["sliding_window"],
                                              True)],
                       "lm_ulysses": [_sm90(layers * steps)] * 2},
                "tp": {"lm_tp": [_sm90(layers * steps)] * 2}}
        paths = dict.fromkeys(COUNTERS, 0)

        def pod_fits(key):
            """The pod's REST fits, one after the other: model -> its
            record."""
            base = f"http://127.0.0.1:{sups[key].port}"
            done = {}
            for model, want in fits[key].items():
                name = "fit_" + model
                tf = time.monotonic()
                staged0 = _staged_rank0(base)
                _http(base, "POST", "/train/tensorflow", {
                    "name": name, "modelName": model, "method": "fit",
                    "methodParameters": {"x": "$corpus.tokens",
                                         "batch_size": DIST_FIT_BATCH,
                                         "epochs": 1}})
                _poll(base, f"/train/tensorflow/{name}")
                staged = _staged_rank0(base)
                records = [d["epochRecord"] for d in
                           _job_docs(base, "train", name)["result"]
                           if "epochRecord" in d]
                losses = [r["loss"] for r in records]
                launches = [_rank_launches(c)
                            for c in records[0]["launchesByRank"]]
                # the rank-0 bytes through the host: at least each step's
                # gradient all-reduce, both ways (gloo sums on the host);
                # at tp=2 no rank holds another's rows, so no gradient is
                # summed: the bytes are the layers' tp collectives
                reduced = {k: staged[k] - staged0[k] for k in staged}
                floor = steps * grad_bytes if key != "tp" else 1
                if launches != want or not all(
                        abs(a - b_) <= 0.01 * b_
                        for a, b_ in zip(losses, reference["loss"])) or \
                        min(reduced.values()) < floor:
                    raise AssertionError(
                        f"(c) {name}: launches {launches} (want {want}), "
                        f"losses {losses} against {reference['loss']}, "
                        f"staged {reduced} (gradients {steps} x "
                        f"{grad_bytes} B)")
                done[model] = {
                    "losses": losses, "launchesByRank": launches,
                    "stagedBytesRank0": reduced,
                    "gradientBytes": grad_bytes,
                    "epochSeconds": records[0]["epochSeconds"],
                    "jobSeconds": time.monotonic() - tf}
            return done

        # the three pods fit at once (each pod's counts and bytes are its
        # own ranks'); the first failure fails the phase
        fitted, failures = {}, []

        def fit_pod(key):
            try:
                fitted[key] = pod_fits(key)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                failures.append(exc)

        tf = time.monotonic()
        fitters = [threading.Thread(target=fit_pod, args=(key,))
                   for key in sups]
        for thread in fitters:
            thread.start()
        for thread in fitters:
            thread.join()
        if failures:
            raise failures[0]
        for key in sups:
            for model, rec in fitted[key].items():
                pod_out[key][model] = rec
                for launched in rec["launchesByRank"]:
                    for k, n in launched.items():
                        paths[k] += n
        out["podFitsSeconds"] = time.monotonic() - tf
        # (g) the tp=2 fit's artifact is the whole flax tree
        pod_out["tp"]["lm_tp"]["artifactShapes"] = _whole_tree_check(
            np, os.path.join(home, "tp"), "fit_lm_tp")
        sups["tp"]._stopping = True
        out["pods"] = pod_out
        # (c) a REST evaluate of the sp pod's ring model: no step shard
        # splits the sequence, so each rank runs the whole-sequence
        # forward kernel once a layer for each batch
        base = f"http://127.0.0.1:{sups['sp'].port}"
        tf = time.monotonic()
        launched0 = _health_launches(base)
        status, body = _http(base, "POST", "/evaluate/tensorflow", {
            "name": "eval_lm_ring", "modelName": "fit_lm_ring",
            "method": "evaluate",
            "methodParameters": {"x": "$corpus.tokens",
                                 "batch_size": DIST_FIT_BATCH}})
        if status != 201:
            raise AssertionError(f"(c) evaluate of lm_ring: {status} {body}")
        _poll(base, "/evaluate/tensorflow/eval_lm_ring")
        launched = _health_launches(base)
        ran = {k: launched[k] - launched0[k] for k in launched}
        evaluated = next(d["result"] for d in _job_docs(
            base, "evaluate", "eval_lm_ring")["result"] if "result" in d)
        want = dict(dict.fromkeys(COUNTERS, 0),
                    flash_fwd_sm90=layers * -(-DIST_FIT_WINDOWS
                                              // DIST_FIT_BATCH))
        if ran != want or not all(np.isfinite(v) for v in
                                  evaluated.values()):
            raise AssertionError(f"(c) evaluate of lm_ring: launches {ran} "
                                 f"(want {want}), {evaluated}")
        for k, n in ran.items():
            paths[k] += n
        out["ringEvaluate"] = {"evaluate": evaluated,
                               "launchesRank0": ran,
                               "jobSeconds": time.monotonic() - tf}
        sups["dp"]._stopping = True

        # (d) a member SIGKILLed mid-fit on the sp pod
        sup = sups["sp"]
        base = f"http://127.0.0.1:{sup.port}"
        _http(base, "POST", "/train/tensorflow", {
            "name": "fit_long", "modelName": "lm_ring", "method": "fit",
            "methodParameters": {"x": "$corpus.tokens",
                                 "batch_size": DIST_FIT_BATCH,
                                 "epochs": 200}})
        deadline = time.monotonic() + 300
        while not any("epochRecord" in d for d in _job_docs(
                base, "train", "fit_long")["result"]):
            if time.monotonic() > deadline:
                raise AssertionError("(d) the long fit never ran an epoch")
            time.sleep(0.1)
        first = list(sup.procs)
        first[1].kill()
        killed = time.monotonic()
        # the monitor's timeout, then a heartbeat and the guard's tick
        bound = 10 * DIST_HEARTBEAT + 4 * DIST_HEARTBEAT
        lost = None
        while lost is None and time.monotonic() - killed < bound + 5:
            docs = _job_docs(base, "train", "fit_long")["result"]
            lost = next((d for d in docs if str(
                d.get("exception", "")).startswith("WorkerLost(")), None)
            time.sleep(0.05)
        lost_s = time.monotonic() - killed
        health = _wait_health(base, lambda h: "podFailure" in h, 5)
        if lost is None or lost_s > bound or \
                health.get("status") != "degraded":
            raise AssertionError(f"(d) after {lost_s:.3f} s: {lost}, "
                                 f"{health}")
        while sup.procs[0] is first[0]:
            if time.monotonic() - killed > 120:
                raise AssertionError("(d) the pod never re-formed")
            time.sleep(0.1)
        again = _wait_health(base, lambda h: h.get("status") == "ok"
                             and h.get("processCount") == 2)
        out["memberLost"] = {
            "workerLostSeconds": lost_s, "boundSeconds": bound,
            "exception": lost["exception"][:200],
            "workerLost": lost.get("workerLost"),
            "podFailure": health["podFailure"],
            "restartSeconds": time.monotonic() - killed,
            "restarts": len(sup._restart_times),
            "healthAfter": again["status"]}
        sup._stopping = True
        # (b) the ranks' results
        t0 = time.monotonic()
        results = []
        for r, proc in enumerate(ranks):
            proc.wait(timeout=600)
            with open(rank_logs[r] + ".out") as f:
                stdout = f.read()
            with open(rank_logs[r] + ".err") as f:
                stderr = f.read()
            line = next((ln for ln in stdout.splitlines()
                         if ln.startswith("rank ")), None)
            if proc.returncode != 0 or line is None:
                raise AssertionError(f"(b) rank {r} failed "
                                     f"({proc.returncode}): "
                                     f"{stderr[-3000:]}")
            results.append(json.loads(line[len("rank "):]))
        ops = {}
        local = DIST_SHAPE["s"] // DIST_RANKS
        for name, (impl, dtype, causal) in DIST_OP_CASES.items():
            per_rank = [res["ops"][name] for res in results]
            hops = ([1] * DIST_RANKS if impl == "ulysses" else
                    _ring_hops(DIST_RANKS, local, DIST_SHAPE["window"],
                               causal))
            route = _sm90 if dtype == "bfloat16" else _tf32x3
            launches = [_rank_launches(p["launches"]) for p in per_rank]
            if launches != [route(n) for n in hops]:
                raise AssertionError(f"(b) {name} launched {launches}, "
                                     f"want hops {hops}")
            gap = per_rank[0]["relL2VsWhole"]
            if dtype == "float32" and max(gap.values()) > 1e-4:
                raise AssertionError(f"(b) {name} against the whole "
                                     f"sequence: {gap}")
            # bf16: each tensor's gap to the float32 whole-sequence
            # kernel within twice the bf16 whole-sequence kernel's own
            # (a dropped or misplaced hop is off by 1e-1 and more)
            ring32 = per_rank[0]["relL2VsWholeFloat32"]
            whole32 = per_rank[0]["wholeRelL2VsFloat32"]
            if dtype == "bfloat16" and any(
                    ring32[t] > DIST_BF16_GAP_RATIO * whole32[t]
                    for t in ring32):
                raise AssertionError(
                    f"(b) {name} against the float32 whole sequence: "
                    f"{ring32}, the bf16 whole kernel's {whole32}")
            fwd = "flash_fwd_" + ("sm90" if dtype == "bfloat16"
                                  else "tf32x3")
            ops[name] = {"forwardLaunchesByRank": [n[fwd] for n in launches],
                         "relL2VsWhole": gap,
                "relL2VsWholeFloat32": per_rank[0]["relL2VsWholeFloat32"],
                "wholeRelL2VsFloat32": per_rank[0]["wholeRelL2VsFloat32"],
                "stagedBytesByRank": [p["stagedBytes"] for p in per_rank]}
            if dtype == "bfloat16":
                ops[name]["relL2RatioToWholeBfloat16"] = {
                    t: ring32[t] / whole32[t] for t in ring32}
        out["ops"] = ops
        grads = {}
        for name, (mesh_spec, attention) in DIST_GRAD_CASES.items():
            per_rank = [results[r]["grads"][name] for r in range(2)]
            if attention == "ring":
                want = [_tf32x3(layers * n) for n in _ring_hops(
                    2, sp_local, LM_CONFIG["sliding_window"], True)]
            else:
                want = [_tf32x3(layers)] * 2
            launches = [_rank_launches(p["launches"]) for p in per_rank]
            rel = per_rank[0]["relL2VsOneRank"]
            # the gradient all-reduce crossed the host both ways
            staged = [p["stagedBytes"] for p in per_rank]
            if launches != want or rel["max"] > 1e-4 or \
                    per_rank[0]["loss"] != per_rank[1]["loss"] or any(
                        min(st.values()) < p["gradBytes"]
                        for st, p in zip(staged, per_rank)):
                raise AssertionError(f"(b') {name}: launches {launches} "
                                     f"(want {want}), {rel}, losses "
                                     f"{[p['loss'] for p in per_rank]}, "
                                     f"staged {staged}")
            grads[name] = {"f32GradRelL2VsOneRank": rel,
                           "loss": per_rank[0]["loss"],
                           "oneRankLoss": results[0]["gradsLoss"],
                           "seqParallel": per_rank[0]["seqParallel"],
                           "launchesByRank": launches,
                           "gradientBytes": per_rank[0]["gradBytes"],
                           "stagedBytesByRank": staged}
        out["grads"] = grads
        out["model"] = _model_parallel_checks(results, layers)
        out["pipelined"] = _pipeline_checks(results)
        out["ranks"] = {"hostInfo": results[0]["hostInfo"],
                        "startSeconds": [r["startSeconds"] for r in results],
                        "seconds": [r["seconds"] for r in results],
                        "waitSeconds": time.monotonic() - t0}

    finally:
        _stop_children()
        for sup in sups.values():
            sup._stopping = True
        for thread in threads:
            thread.join(timeout=150)
    if codes != {"dp": 0, "sp": 0, "tp": 0}:
        raise AssertionError(f"the supervisors ended {codes}")
    out["phaseSeconds"] = time.monotonic() - phase_t0
    log.append("distributed " + json.dumps(out))
    return {"distributed": paths}


# processes a phase runs beside its own work: stopped when it ends or
# fails
_CHILDREN: list = []


def _stop_children() -> None:
    while _CHILDREN:
        proc = _CHILDREN.pop()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _phase_home():
    """A phase's temporary home. Its removal ignores errors: a service
    context's shutdown does not wait for jobs still running (the job
    pool's ``shutdown(wait=False)``), so one of them can still write a
    file while the directory is removed, and nothing the script checks
    depends on that removal."""
    return tempfile.TemporaryDirectory(ignore_cleanup_errors=True)


def _walled(walls: dict, fn):
    """``fn``, adding its wall seconds to ``walls`` under its name."""
    def run(*args):
        t0 = time.monotonic()
        try:
            return fn(*args)
        finally:
            walls[fn.__name__] = time.monotonic() - t0
    return run


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from learningorchestra_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"device: {smi.stdout.strip()}", flush=True)
    t0 = time.monotonic()
    _build.build()
    print(f"kernel build seconds: {time.monotonic() - t0:.3f} "
          f"(sources {_build.sources()})", flush=True)
    ptxas = {name: _ptxas_report(text)
             for name, text in sorted(_build.BUILD_LOG.items())}
    print("ptxas " + json.dumps(ptxas), flush=True)
    spilled = [v for name, variants in ptxas.items()
               if name.endswith(("_sm90", "_tf32x3"))
               for v in variants if v.get("spillStores", 1)
               or v.get("spillLoads", 1)]
    if spilled:
        print(f"chip_smoke: tensor-core variants spill (or ptxas did not "
              f"report): {spilled}", file=sys.stderr)
        return 1

    log: list = []
    # each phase's wall seconds (the ``walls`` line)
    walls: dict = {}
    for name in [n for n in globals() if n.endswith("_phase")]:
        globals()[name] = _walled(walls, globals()[name])
    if "--only" in sys.argv:
        # iteration aid: the build, then the named self-contained phases
        # alone; no kernels line and no result line
        phases = {"neural": neural_phase, "keras": keras_phase,
                  "fusion": fusion_phase, "ckptAsync": ckpt_async_phase,
                  "function": function_phase,
                  "transform": transform_phase, "builder": builder_phase,
                  "ingest": ingest_phase,
                  "lifecycle": lifecycle_phase,
                  "scheduler": scheduler_phase, "observe": observe_phase,
                  "featurePlane": feature_plane_phase,
                  "distributed": distributed_phase}
        try:
            for name in sys.argv[sys.argv.index("--only") + 1].split(","):
                with _phase_home() as home:
                    launched = phases[name](torch, log, home, {})
                print(f"{name} launches " + json.dumps(launched))
        except BaseException:
            _stop_children()
            for line in log:
                print(line)
            traceback.print_exc()
            return 1
        for line in log:
            print(line)
        return 0
    try:
        entries = kernel_phase(torch, log)
        entries.update(bwd_kernel_phase(torch, log))
        serve_yard: dict = {}
        with _phase_home() as home:
            served = slice_phase(torch, log, home, serve_yard)
        with _phase_home() as home:
            paged = paged_phase(torch, log, home, serve_yard)
        del serve_yard
        yard: dict = {}
        with _phase_home() as home:
            paths = {"serve": served, **paged,
                     **train_phase(torch, log, home, yard)}
        with _phase_home() as home:
            paths.update(pipeline_phase(torch, log, home, yard))
        with _phase_home() as home:
            paths.update(ckpt_async_phase(torch, log, home, yard))
        with _phase_home() as home:
            paths.update(lm_options_phase(torch, log, home, yard))
        with _phase_home() as home:
            paths.update(classifier_phase(torch, log, home, yard))
        with _phase_home() as home:
            paths.update(serving_plane_phase(torch, log, home, yard))
        train_losses = yard["losses"]
        del yard
        with _phase_home() as home:
            paths.update(neural_phase(torch, log, home, {}))
        with _phase_home() as home:
            paths.update(keras_phase(torch, log, home, {}))
        with _phase_home() as home:
            paths.update(fusion_phase(torch, log, home, {}))
        with _phase_home() as home:
            paths.update(function_phase(torch, log, home, {}))
        with _phase_home() as home:
            paths.update(transform_phase(torch, log, home, {}))
        with _phase_home() as home:
            paths.update(builder_phase(torch, log, home, {}))
        with _phase_home() as home:
            paths.update(ingest_phase(torch, log, home, {}))
        with _phase_home() as home:
            paths.update(lifecycle_phase(torch, log, home, {}))
        with _phase_home() as home:
            paths.update(scheduler_phase(torch, log, home, {}))
        with _phase_home() as home:
            paths.update(observe_phase(torch, log, home, {}))
        with _phase_home() as home:
            paths.update(feature_plane_phase(
                torch, log, home, {"losses": train_losses}))
        with _phase_home() as home:
            paths.update(distributed_phase(torch, log, home, {}))
        # each kernel's main path: serving (float32) for the split-TF32
        # forward, the bf16 fit for the wgmma kernels, the float32 fit for
        # the split-TF32 backward
        main_path = {"flash_fwd_sm90": "train",
                     "flash_bwd_dq_sm90": "train",
                     "flash_bwd_dkv_sm90": "train",
                     "flash_fwd_tf32x3": "serve",
                     "flash_bwd_dq_tf32x3": "trainFloat32",
                     "flash_bwd_dkv_tf32x3": "trainFloat32"}
        missing = [name for name, path in main_path.items()
                   if name not in entries or not paths[path][name]]
        if missing:
            raise AssertionError(f"kernels never measured or never launched "
                                 f"on their path: {missing}")
    except BaseException:
        _stop_children()
        for line in log:
            print(line)
        traceback.print_exc()
        return 1
    # the line of each TPU kernel (learningorchestra_tpu/ops/attention.py)
    replaces = {"fwd": 188, "bwd_dq": 338, "bwd_dkv": 402}
    kernels = []
    for name in COUNTERS:
        op, tensor_core_route = name[len("flash_"):].rsplit("_", 1)
        entry = entries[name]
        path = main_path[name]
        # route: the kernel's language (CUDA C++, no Triton);
        # tensorCoreRoute: the port's route that launches it (_route)
        entry.update({
            "name": name, "route": "cuda",
            "tensorCoreRoute": tensor_core_route,
            "source": f"learningorchestra_tpu_torch/csrc/{name}.cu",
            "replaces": f"learningorchestra_tpu/ops/attention.py:"
                        f"{replaces[op]}",
            "launches": paths[path][name], "mainPath": path,
            "launchesByPath": {p: c[name] for p, c in paths.items()}})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    for line in log:
        print(line)
    print("walls " + json.dumps(walls))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
