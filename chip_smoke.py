"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own line; any failure exits nonzero):

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds every kernel source under
   learningorchestra_tpu_torch/csrc/, all at once;
3. kernels against their plain PyTorch versions, on the card:
   K1 flash-attention forward at the serving shape (64, 12, 512, 64) f32
   with a key mask and a fully-masked row, plus the fine-tune shape
   (32, 12, 128, 64) bf16, bf16 at T=512, causal, causal+window,
   unaligned lengths, the decoder's causal (8, 12, 1024, 64) in bf16
   and f32 and the MoE decoder's causal (8, 8, 1024, 32) in bf16 and f32;
   K2 (dQ) and K3 (dK, dV) at the fine-tune shape in
   bf16 and f32 with a key mask and a fully-masked row (exact zeros
   asserted), plus (8, 12, 512, 64) bf16, causal, causal+window, unaligned
   lengths, D = 40 / 128 and the decoders' causal (8, 12, 1024, 64) and
   (8, 8, 1024, 32) in bf16; every K1 case and every bf16 K2/K3
   case launched twice and required bitwise equal (run to run), and no
   register spills in any tensor-core instance of K1, K2 or K3 (ptxas);
   K4 quantize bit-exact and K5 dequantize exact on every quantized leaf
   of a BERT-base model, launched once per leaf and grouped (one launch
   over the whole flax tree through quantize_pytree / dequantize_pytree),
   and on edge matrices (widths 1, 3, 33, 64, 3072, 4100, one row, an
   all-zero row, +-1e20, exact halves, a misaligned source, the decoder's
   (768, 50257) head and (50257, 768) token table) in both
   routes; stochastic bits equal to plain plus a mean-bias check over 256
   seeds; no register spills in quant.cu;
4. training: one batch of BERT-base (full width and depth, random weights
   from a seeded torch.Generator) in f32 on the card against the CPU plain
   path, loss and every parameter's gradient; then the slice's first main
   path: ``BertModel.fit`` for 2 epochs of 250 seeded rows at T=128,
   batch 32, bf16 compute on f32 masters, and ``evaluate``; losses finite,
   parameters moved, K1/K2/K3 launch counters = 12 per step (+ K1 per
   evaluate batch); step time (CUDA events, second epoch); a
   torch.profiler breakdown of train steps by kernel family;
5. serving, the second main path: the trained model saved as an int8
   artifact (K4), loaded by the port's REST server on the card (K5), and
   ~24 concurrent predicts of 1-8 rows at T=512 answered through coalesced
   bucket dispatches; every answer is checked for status, shape and
   finiteness, a few rows against the same artifact run on the CPU (plain
   path), and the kernels' launch counters against the dispatches (K4 and
   K5: one grouped launch per 64 leaves at the save and at the load, and
   51 leaves each); then the save and the load replayed part by part
   (``cold_start``: synchronised wall time of each part, and two ways of
   uploading the int8 leaves);
6. timings (CUDA events, after warm-up; K1 and the forward of
   scaled_dot_product_attention at the serving shape in f32, whose kernel
   name is printed from one profiled call; K1, K2/K3 and SDPA's forward and
   backward at the fine-tune shape and at (8, 12, 512, 64) bf16; K4 and
   K5 over the artifact's 51 leaves grouped and per leaf, as device time
   and paced by the host, beside torch.mul, and K4's stochastic route at
   the Dense_0 shape), a torch.profiler breakdown of one 64-row bucket by
   kernel family, and the `kernels` JSON line;
7. the zoo (BASELINE configs 2, 3, 5), each at full width and depth with
   seeded random weights: ``MnistCNN`` on (16384, 28, 28, 1) at batch
   1024 for 4 epochs, ``ResNet50`` (1000 classes) on (512, 224, 224, 3)
   at batch 64 for 2, both bf16 on f32 masters, and ``LSTMClassifier()``
   on 2048 rows of T=80 (pad tails, one all-pad row) at batch 32 for 3,
   in f32.  Each: one batch's loss and gradients on the card against the
   CPU at the bars of phase 4 (ResNet-50 at 8 rows in f64, see
   ``run_zoo``), steady samples/s and step ms over epochs 2..N (CUDA
   events), a torch.profiler breakdown of one step; then each saved as an
   int8 artifact (K4: one grouped launch, every leaf's bits against plain
   K4 on the card, its (rows, d) and row class) and loaded back (K5: one
   launch, exact against plain), predictions within 1e-3 of the CPU; K4
   and K5 timed over the ResNet-50 artifact's 54 leaves against their
   bytes bound; the MnistCNN artifact served over REST to 24 concurrent
   requests of 1-16 images, checked against the CPU;
8. the REST pipeline: the port's ``APIServer`` on the card runs phase 4's
   fine-tune as named, lineage-tracked async jobs over HTTP — the 250 rows
   as a CSV (``POST /dataset/csv``, 409 on a duplicate), a projection of
   the token columns, ``POST /model/tensorflow`` of BERT-base at max_len
   128 (through the JAX package's module path, an alias), ``POST
   /train/tensorflow`` (2 epochs, batch 32, ``quantize_checkpoint``:
   K1/K2/K3 12 per step, K4 once at the int8 publication), evaluate and
   predict on the train job (K5 once per load, K1 per batch; predictions
   within 1e-3 of the same artifact on the CPU), ``POST
   /serve/<train job>/predict``, a failing train job (missing column:
   ``failed``, the exception in its execution document), the
   ``checkpoint_dir`` 406 and a bare PATCH re-run (K4 once more); each
   job's counters at 0 before its request and read after it finished;
   the ``rest_pipeline`` line (card, power limit, each job's seconds
   from request to finished and launches, ``fitTime``, the job layer's
   own seconds, the artifact's save and load seconds);
9. classical estimators and the Titanic pipeline: (a) all 19 classical
   estimators fitted and answering on the card and on the CPU, held
   against each other, at two shapes: Kaggle Titanic's (891 rows of the
   builder's 7 features, 2 classes, seeded at train.csv's schema) and UCI
   Covertype's (54 features, 7 classes, every predict over the published
   581,012 rows; fit rows cut per estimator in ``COVTYPE_FIT_ROWS``, each
   cut in its line as ``fit_rows``; the CPU reference answers every row
   too, and computes its decision scores only where a label differs),
   t-SNE at 1,000 points; the CPU reference runs in two child processes
   (``--cpu-reference``, Covertype gradient boosting in the second,
   ``CPU_REFERENCE_SECOND``) from the phase's start, beside the card's
   side and (b), and the Covertype comparisons come after (b); labels
   equal but at ties within f32 rounding (``MARGIN_RTOL``, each flip
   counted in the line), f32 answers within ``ANSWER_RTOL``, the
   solvers' coefficients within ``COEF_RTOL``, t-SNE by its KL
   divergence; each one's fit and predict seconds (``estimators_<shape>``
   lines); (b) the Titanic pipeline over REST on the card: a seeded
   891-row CSV, ``PATCH /transform/dataType``, a projection, a
   ``StandardScaler`` transform, config 1's RandomForest train / evaluate
   / predict (its pickle holds CPU tensors only), the builder's five
   classifiers at once, an RF grid tune (2x2) and a BERT-base tune over
   two learning rates on phase 8's token CSV (K1/K2/K3 launches per
   trial, K4 once at the best candidate's int8 publication); each job's
   seconds from request to finished (``titanic_rest`` line); every REST
   fit now saves its final epoch as a managed checkpoint (phase 8's
   ``final_checkpoints``, the BERT tune's ``trial_checkpoints``);
10. the crash drill: the port's ``APIServer`` on the card in a child
   process (``--crash-drill-child``, whose epochs from the third on wait
   ``CRASH_DELAY_S`` first) with a wildcard webhook aimed at a receiver in
   this process; phase 8's CSV, projection and BERT-base model, then a
   train job of 4 epochs checkpointing each (async), ``quantize_checkpoint``;
   SIGKILL once ``latest.json`` names step 2 or later; a second
   ``APIServer`` here over the same store replays the journal and
   re-dispatches the job, which resumes from the committed step and
   finishes with ``engineEpoch`` 2 and 4 history epochs, K1/K2/K3
   launched 12 x 8 steps x the epochs after that step, K4 once; the
   webhook's ``finished`` event received; an evaluate of the recovered
   artifact (K5 once); the same job run uninterrupted, its final f32
   checkpoint against the recovered one's (bf16 bar 3e-2; 0 expected);
   the ``crash_drill`` line (each checkpoint's snapshot wait, writer
   seconds and bytes; resume-load, journal replay, boot-to-redispatch and
   to-finished seconds; launches; the parameter difference);
11. the text pipeline and beyond-RAM datasets over REST on the card:
   seeded review CSVs at the Large Movie Review Dataset's row shape (its
   25,000 + 25,000 reviews cut to ``IMDB_ROWS`` each, balanced; a Zipf
   vocabulary of 20,000 synthetic word types with sentiment-bearing ones,
   lengths long-tailed around 180 words), ``POST /dataset/csv`` of both
   and a histogram of the label; ``/transform/text`` (BPE trained to
   8,000 tokens, maxLen 128, 4,096-row shards: 2, the second a ragged
   tail of 8 rows) and the held-out split and a maxLen-80 pair with
   ``tokenizerFrom``; BERT-base (phase 8's model) trained streaming for 1
   epoch at batch 32 with ``quantize_checkpoint`` (129 steps: K1/K2/K3 12
   each per step, K4 once; one program per distinct shard length), a
   streaming evaluate on the test split (K5 once, K1 per batch) and a
   predict on the bare test dataset (K5 once, K1 per dispatch;
   rows within 1e-3 of the same artifact on the CPU); config 3's
   ``LSTMClassifier()`` trained streaming on the maxLen-80 pair and
   evaluated; ``/explore/curves`` of both fits, ``/function/python``
   taking 2,000 test rows and labels, a t-SNE ``/explore/scikitlearn``
   plot of them coloured by label, every image a valid 960x720 PNG;
   ``POST /dataset/tensor`` of a seeded (60,000, 28, 28, 1) f32 ``.npy``
   (15 shards) and a streaming ``MnistCNN`` fit at batch 1,024; a
   sharded CSV at Covertype's schema cut to 100,000 rows (parsed by the
   native CSV engine) and a streaming ``MLPClassifier`` fit; a generic ingest;
   BERT-base streaming over 2 shards of 256 rows against the in-memory
   fit of the same rows (bf16 bar 3e-2, 0 expected) and one shard's fit
   profiled; the ``text_pipeline`` line (each job's seconds and
   launches, BPE train seconds and encode rows/s, streaming samples/s
   and step ms beside phase 4's in-memory step, each fit's
   ``shard_wait_s``, the profiled shard's idle share, evaluate metrics);
12. data-parallel training over REST on the card (``run_distributed``),
   BERT-base at full width and depth on phase 8's 250 token rows at
   T=128: (a) world 1 over REST, ``POST /train/horovod`` of phase 8's
   model (2 epochs, global batch 32, ``shuffle: false``,
   ``quantize_checkpoint``, a ``monitoringPath``) on the server's one
   leased card, so NCCL: the job finishes with ``distributed`` true,
   ``meshDevices`` 1 and 2 history rows with ``samples_per_sec``, the rank
   launches K1/K2/K3 12 per step, the parent K4 once;
   ``GET /monitoring/tensorflow/<nick>`` names a logdir holding a tfevents
   file, the CSV and rank 0's ``torch.profiler`` trace; a predict on the
   job's int8 artifact (K5 once, K1 per batch) within 1e-3 of the same
   artifact on the CPU; its final f32 checkpoint against a single-device
   ``BertModel.fit`` of the same rows (bf16 bar 3e-2; 0 expected);
   (b) world 2 (gloo, both ranks on ``cuda:0``) through
   ``DistributedTrainer`` against one device in this process (which (a)
   holds world 1 to, bit for bit) on 128 of the rows, 1 epoch of plain
   SGD: each rank and the one device launch K1/K2/K3 12 per step, world
   2 within the bf16 bar of the one device and its parameter change
   within ``SYNC_BAR`` of the one device's per leaf (as is (a)'s against
   the single-device fit's), and the planted sync faults (sync skipped or rank 1's gradient lost, emulated
   by a single-device fit of rank 0's rows; a mean for the sum) read
   above that bar; each rank's step and gradient-sync ms by CUDA events
   and the all-reduce's share of a step; (c) ``POST /builder/pytorch`` with
   ``nWorkers`` 2 running a function that returns its rank and the card's
   name (rows [0, 1]); (d) the token CSV served by ``http.server`` on
   localhost, ingested by ``POST /dataset/csv`` (rows equal to the file
   ingest); the ``distributed`` line (card, power limit, each job's
   seconds and ``fitTime``, step ms, samples/s, spawn-to-first-step
   seconds, launches per rank, the parameter differences);
13. the decoder LM and streaming generation (``run_decoder``): a
   ``DecoderLM`` at GPT-2 small's published widths (vocab 50257, 768
   wide, 12 layers of 12 heads, MLP 3072, 1024 positions; learned
   positions, an untied biased head) seeded from ``torch.Generator`` 0:
   (a) one f32 step of 2 rows (one with a pad tail) on the card against
   the CPU at phase 4's bars, T shortened to ``DEC_CPU_T`` there; (b)
   ``fit`` 2 epochs of 64 rows at T=1024 cut from a seeded 128-token
   cycle, batch 8, bf16 on f32 masters, lr 3e-4 (losses fall, K1/K2/K3
   causal 12 per step, step ms, tokens/s, one profiled step's idle
   share); (c) the int8 artifact (K4 one grouped launch) loaded by
   ``APIServer`` (K5 one launch) and ``POST /serve/<model>/generate``:
   JSON for 8 prompts of 16-256 tokens (64 new each; the decode launches
   no K1), 4 SSE streams of which 2 open while the first 2 are mid-
   flight, one stream DELETEd after its 5th token (at most one more
   token, its slot free, a second DELETE 404) and a sampled request
   (tokens in range, never 0); (d) the cached decode's f32 step logits
   at every generated position against one causal f32 forward (K1) of
   the final buffer, ``DEC_LOGIT_BAR``*(1+|ref|), and the engine's tokens
   against in-process solo decodes (first divergence reported); (e) (d)'s
   check for rope + GQA 12/4 + window 256 at 2 layers, untrained; (f) the
   ``decoder`` line: TTFT p50 / max and ITL p50 / p99 of the SSE streams
   (client side), engine (best of 2) against sequential solo (1 pass)
   tokens/s, KV bytes per pool, the engine's graph captures, launches,
   the phase's seconds (each step cell is timed in phase 15);
14. fleet serving over REST (``run_fleet``), after every phase that
   trains (a replica holds the card): phase 4's int8 BERT-base and phase
   13's DecoderLM artifacts on one server: (a) with the context's own
   one-card pool, ``POST /serve/<bert>/replicas {min 1, max 2}`` cuts
   the model over to one replica holding ``cuda:0`` (K5 0: it shares the
   resident module), phase 4's 24 requests come back from replica 0
   within ``CPU_ATOL`` of the single path with K1 = 12 x dispatches, a
   second replica answers 503 + Retry-After within the lease budget
   while predicts go on, and a REST train job waits for the card until
   ``DELETE /serve/<bert>/replicas``; (b) ``ctx.leaser`` replaced by two
   lease units on the one card (the JAX fleet tests' seam): 16 clients
   of 8-row T=512 requests make the autoscaler scale 1 -> 2 (pre-warm on)
   and, once they stop, drain back to 1 with its unit returned, only 429s
   allowed; then the same burst at 1 and at 2 replicas, and K1 = 12 x
   (dispatches + pre-warm dispatches); (c) the DecoderLM at 2 replicas
   after a pre-warm that replays its decode steps: 8 JSON prompts and 2
   SSE streams split over both replicas' pools and equal to solo
   decodes, an abort that frees its replica's slot; the ``fleet`` line
   (cutover, scale-up and drain seconds, each window's rows/s, p50, p99
   and requests per replica, the 2/1 ratio, decode streams per replica
   and tokens/s, K1 and K5 on the fleet paths, the 503 and 429 counts);
15. the program cache and the cost plane (``run_program_cache``), with
   ``LO_TPU_COSTS_PEAK_FLOPS`` set to the card's dense bf16 peak for the
   whole run: (a) from a cold program cache and cost ledger, phase 8's
   CSV, projection and BERT-base model, then the same train spec twice
   over REST (the first job's ``compileCache`` misses >= 1 and it runs
   FLOP analyses; the second's misses 0, hits >= 1, no analysis; both
   jobs' seconds; K1/K2/K3 12 per step, K4 once each), a
   2-candidate tune of one architecture (its ``compileCache``: every
   program a hit), ``GET /monitoring/tensorflow/compileCache``; (b) each
   train job's ``deviceTime`` (device s, FLOPs, MFU in (0, 1]) and its
   FLOPs per step within ``PC_FLOPS_BAR`` of the analytic BERT-base count
   at (32, 128), 4 predicts of the trained artifact (K5 once, K1 12 each)
   and ``GET /observability/costs`` by model and bucket (phase 14's
   models included); (c) phase 13's int8 DecoderLM on a fresh server: 8
   JSON prompts and 2 SSE streams through the step programs' CUDA
   graphs, token for token equal to phase 13's solo decodes, then each
   (S, Tk) cell's graph step against the eager ``build_step`` (host-paced
   and device ms, capture ms, graph-pool bytes); the ``program_cache``
   line;
16. durable warm start and live profiling (``run_warm_start``): (a) the
   restart drill: two fresh child processes (``chip_smoke.py --aot-child
   A|B DIR``) sharing one durable program store (``LO_TPU_AOT_ENABLED``,
   ``LO_TPU_AOT_PREWARM``, ``LO_TPU_AOT_DIR``), each with its own store
   and volumes, drive the REST server through the same requests: phase
   8's CSV, projection and BERT-base model, a train job of 1 epoch (8
   steps at 32x128 bf16, K1/K2/K3 12 each per step, K4 at the int8
   publication), one predict per row count 1-8 of its artifact (K5 at the
   load, K1 12 per dispatch), ``/load`` of phase 13's int8 DecoderLM (K5)
   and one SSE stream of 64 tokens; A starts cold and writes the store, B
   joins its boot pre-warm first and must read ``aot.hits`` = A's stored
   programs, ``misses`` 0 and no FLOP analysis, its restored decode cell
   captured at ``/load`` (none during the stream), K1-K5 launched as A
   did, losses within 1e-5 (relative), answers within 1e-6, tokens
   equal; each child's job s, first answer s, TTFT, pre-warm s and store
   bytes; (b) a live capture in this process: phase 4's int8 BERT-base
   served, 2 rounds of 8 concurrent predicts at T=128 without and then
   under ``POST /observability/profile/start`` (a second start 409),
   stopped over REST, its ``.pt.trace.json`` fetched through ``?file=``:
   K1's kernel events equal K1's launch counter over the capture (12 per
   dispatch, the batcher's thread); serve p50 with and without the
   capture, the trace's bytes; a 1 s capture stopped by its timer within
   3 s, the retention bound (2) and DELETE; the ``warm_start`` line;
17. mixture-of-experts models (``run_moe``) at the JAX package's default
   widths, created over REST through its module path: ``MoEDecoderLM``
   (vocab 32000, 256 wide, 4 layers of 8 heads of 32, MLP 1024, 1024
   positions, 8 experts top-2 at capacity 1.5, MoE on every second
   block) fitted 2 epochs of 4 steps on 32 rows at T=1024 and
   ``MoETransformerClassifier`` (vocab 20000, 128 wide, 2 layers, 256
   positions, 8 experts) 2 epochs of 4 steps on 128 rows at T=256, both
   bf16 on f32 masters over ``/train/tensorflow`` (K1/K2/K3 one each per
   layer per step; the loss beside the MoE layers' aux terms; the card's
   peak memory over the fit); the decoder's f32 forward on the card against
   the CPU's from the same weights (logits within ``MOE_LOGIT_BAR``, the
   share of token routings whose top-2 experts agree, the routings the
   bf16 cast flips); each model saved as an int8 artifact (K4, one
   launch) and loaded by the server (K5, one launch), every expert leaf's
   int8 bits equal to the plain quantize of the trained leaf and its
   served values to the plain dequantize; 4 SSE ``/generate`` streams of
   the decoder through the CUDA-graph decode step, 2 admitted while 2
   are mid-flight, each equal to a solo ``generate`` (TTFT, ITL, each
   cell's graph and eager step ms); 8 concurrent classifier
   ``/predict`` requests (K1 2 per dispatch, rows within ``CPU_ATOL`` of
   the artifact on the CPU); K1 causal bf16 at the decoder's (8, 8,
   1024, 32) beside its bound and SDPA; the ``moe`` line;
18. long-context training over a sequence-parallel ring
   (``run_long_context``), ``LongContextTransformer`` at the JAX
   package's defaults (vocab 32000, 256 wide, 4 layers of 8 heads of 32,
   MLP 1024, 65,536 positions, 2 classes): (a) two gloo rank processes
   on cuda:0 (``--ring-child``) hold ``ring_flash_attention`` at (2,
   4096, 8, 32) in f32 and bf16, causal and not, with a fully masked
   row, against ``mha_reference`` over the whole sequence (O and
   dQ/dK/dV: f32 2e-5 / 5e-5, bf16 3e-2; the masked row exactly 0;
   K1/K2/K3 sp per rank, s + 1 on causal rank s), and one f32 step of 2
   rows at T = 4,096 over the ring against one device (loss and gradient
   norm within 1e-4); meanwhile (c) a server whose leaser holds two units
   of cuda:0 creates the model over REST, trains it with ``POST
   /train/horovod`` and ``"mesh": {"sp": 2}`` (2 steps at T = 4,096,
   K1/K2/K3 8 per rank per step), publishes it int8 (K4) and loads it
   (K5) with every leaf exact, and answers 8 concurrent ``/predict``
   requests at T = 4,096 on one device (K1 4 per dispatch; the one-row
   request against the CPU); then (b) ``DistributedTrainer(spec=
   MeshSpec(sp=2), devices=["cuda:0"] * 2)`` fits 2 bf16 steps of 2 rows
   at T = 65,536 (K1/K2/K3 8 per rank per step; each rank's step ms and
   peak memory), and K1-K3 at a ring step's (2, 8, 32768, 32) are held
   against their plain versions in chunks of 2,048 query rows (bf16
   3e-2, absolute and of the largest plain value), then timed beside
   their bounds and SDPA; the ``long_context`` line;
19. expert parallelism and the data-parallel MoE fit
   (``run_expert_parallel``): (a) four gloo rank processes on cuda:0
   (``--ep-child``) lay dp 2 x ep 2 and step ``MoETransformerClassifier``
   at the JAX package's defaults (vocab 20000, 128 wide, 2 layers of 4
   heads, 8 experts top-2, T = 256) once in f32 on 16 of 32 rows each,
   each rank holding 4 of the 8 experts, against the same step of the
   whole batch on one device (objective within 1e-5, every gradient leaf
   within 1e-3 of its largest entry; after an SGD update the replicated
   leaves bit-equal across each expert group); meanwhile (c) a server
   whose leaser holds two units of cuda:0 trains ``MoEDecoderLM`` at its
   defaults with ``POST /train/horovod`` and ``"mesh": {"ep": 2}`` (2
   steps of 8 rows at T = 1,024), publishes it int8 (K4, all 8 experts of
   each layer) and loads it (K5), and ``/generate`` of 8 tokens equals a
   one-device greedy decode of the same artifact; then (b)
   ``DistributedTrainer(spec=MeshSpec(dp=2, ep=2), devices=["cuda:0"] *
   4)`` fits the classifier 8 bf16 steps of 32 rows (each rank's step,
   gradient sync and expert exchange ms, peak memory, parameter bytes,
   K1/K2/K3 2 per step), and K1-K3 at a rank's (16, 4, 256, 32) with a
   key mask are held against their plain versions (bf16 3e-2); the
   ``expert_parallel`` line;
20. the operations plane (``run_operations_plane``) on a server with a
   0.25 s rollup tick and SLO windows of 2 and 4 s: (a) phase 8's
   BERT-base over REST on 96 rows, a train job of 3 epochs of 3 bf16
   steps at 32x128 (``checkpoint_every`` 1) under an armed
   ``train.epoch`` preempt (``after`` 2, ``max_triggers`` 1): it finishes
   with one ``preempted`` record and ``preemptions`` 1, K1/K2/K3 12 per
   step of epochs 0-2 run once (a restart would add 6 steps), K4 once,
   its two leases released in turn and the card's allocated bytes back
   at their level before the job, its losses within 1e-5 (relative) of
   an unfaulted twin job's; (b) its span tree under the submit's
   ``X-Request-Id`` (queue wait, two leases, the two attempts, epochs 0
   and 1 under attempt 1 and epoch 2 under attempt 2); (d) the int8
   artifact loaded (K5) and 24 one-row predicts under ``serve.apply``
   armed ``error`` once: one dispatch's requests fail, the rest answer
   within ``CPU_ATOL`` of the CPU, K1 12 per successful dispatch, the
   server live after; (c) ``/metrics.prom`` deltas over (a)-(d) (fault
   triggers, finished and preempted jobs, predicts answered, the
   predict route's 5xx) and phase 13's SSE streams' token and TTFT
   deltas against what they received; (e) a runtime predict-latency
   objective under a ``serve.apply`` delay fires, exactly one bundle
   lands (``slo_firing``, its ``flight.json`` holding the delay triggers
   and the predicts' request ids), and the alert resolves after the
   disarm; (f) the disabled cost of ``faults.hit`` and of a ``span`` (ns,
   in process) and the predict p50 with the plane on, beside the card;
   the ``operations_plane`` line;
21. the process entry point (``run_entry_point``): a child started as
   ``python -m learningorchestra_tpu_torch serve --port P`` (no device
   argument: the card) over a store holding phase 4's int8 BERT-base
   artifact, with the lock witness on and its exit dump named; through
   the port's ``client.py``: the load (K5) and 16 concurrent predicts
   of 1-8 rows at T=128 under a ``/observability/profile`` capture whose
   device records show K5 once and K1 12 per dispatch and no library
   attention kernel, rows within ``CPU_ATOL`` of this process's CPU
   forward of the same artifact, 16 one-row predicts for the p50 with
   the witness on; the gateway: a keyed POST replayed (its job ran
   once), the cached ``GET /registry``, ``GET /metrics`` counting the
   predict route, ``GET /status`` HTML, ``GET /observability/locks``
   with edges and no stall; SIGINT: exit 0 within ``ENTRY_EXIT_S``, and
   the dump's edges all in the port's static lock graph; the
   ``entry_point`` line;
22. the control plane, store HA and the native store
   (``run_control_plane``): two ``serve`` children (engines A and B) over
   one python store with the cluster on (distinct engine ids, a 3 s
   claim TTL) and a ``standby`` child shipping that store's WALs and
   probing B, all on the card; phase 20's BERT-base job (96 rows, 3
   epochs of 3 bf16 steps, a checkpoint every epoch) trained through A
   under ``X-Tenant`` t22 (A's second epoch held at its top by an armed
   ``train.epoch`` delay): a t22 job answers 429 with the same error and
   ``Retry-After`` on both engines while another tenant's runs; A is
   SIGKILLed after its first checkpoint, B steals the claim and resumes
   from it: K1/K2/K3 12 per step run on B and K4 once in B's own
   capture, exactly one ``finished`` journal record, under B's epoch, and
   losses within 1e-5 (relative) of phase 20's unfaulted twin; B serves
   the int8 artifact, then is SIGKILLed under a write storm: the standby
   promotes, every acknowledged write is on it, its capture shows K5
   once and K1 12 per dispatch, its rows within ``CPU_ATOL`` of B's; B
   restarted with the standby as ``LO_HA_PEER`` exits 3 (refused); then
   phase 11's 100,000-row Covertype-schema CSV through the native store
   and CSV engine and through the python store's row path: the same
   shards, both times and g++'s version; the ``control_plane``,
   ``store_ha`` and ``native_store`` lines;
23. last line: {"ok": true, "device": {...}}.

Without a visible GPU, or without the repository beside it, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import copy
import http.client
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet), used for bound_ms.
# Tensor cores, dense.  K1's f32 route runs each f32 product as three
# TF32 products (split TF32), so its operations bound is 3x its FLOPs at
# the TF32 rate (not f32 FLOPs at the CUDA cores' 67 TFLOP/s).
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
PEAK_BYTES = 3.35e12  # HBM3

PATH_SHAPE = (64, 12, 512, 64)  # largest serving bucket, BERT-base heads
SEQ_LEN = 512
N_REQUESTS = 24
CPU_ATOL = 1e-3
# BERT fine-tuning recipe (Devlin et al. 2019, run_classifier.py defaults):
# max_seq_length 128, train_batch_size 32; the JAX default lr 2e-5.
TRAIN_SHAPE = (32, 12, 128, 64)  # (batch, heads, T, head dim) of K2/K3
TRAIN_ROWS, TRAIN_EPOCHS = 250, 2
# One f32 batch, card vs CPU: per parameter max|dg| <= GRAD_RTOL *
# max|g| + GRAD_ATOL_REL * (the model's largest gradient); the second
# term covers parameters whose gradient is rounding noise on both sides
# (the key bias: softmax ignores a per-row shift).
GRAD_RTOL = 1e-3
GRAD_ATOL_REL = 1e-6
LOSS_RTOL = 1e-5
# About 50 ms of device time at the H100's clocks: longer than the host
# takes to enqueue any timed run below.
SLEEP_CYCLES = 100_000_000

failures: list[str] = []
T_START = time.perf_counter()


def phase(name: str, ok: bool, detail: str) -> None:
    print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        failures.append(f"{name}: {detail}")


def time_ms(fn, reps: int = 10, warmup: int = 2,
            hide_launch: bool = True) -> float:
    """Mean device time of fn() over reps, by CUDA events.

    With ``hide_launch`` a device-side sleep is queued before the start
    event, so the host enqueues the reps while the card is still busy and
    the interval holds the kernels' own time, not the host's launch rate
    (which dominates short kernels launched one by one through ctypes).
    Without it the interval is what a caller on the host waits."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hide_launch:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) for each
    entry function in nvcc's ``-Xptxas -v`` output."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = _kernel_name(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spills))
            name = None
    return out


def _kernel_name(mangled: str) -> str:
    """``flash_bwd_dq_tc_kernel<64,64,true>`` from an Itanium-mangled
    name: the length-prefixed identifier that ends in "kernel", then its
    template arguments."""
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        start = i + m.end()
        ident = mangled[start:start + int(m.group())]
        i = start + len(ident)
        if ident.endswith("kernel"):
            tail = mangled[i:]
            if not tail.startswith("I"):
                return ident
            names = {"f": "f32", "13__nv_bfloat16": "bf16",
                     "Lb0E": "false", "Lb1E": "true"}
            args = re.findall(r"(f|13__nv_bfloat16|Lb[01]E|Li(\d+)E)",
                              tail.split("EEv")[0])
            return ident + "<" + ",".join(n or names[a] for a, n in args) \
                + ">"
    return mangled


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase 3: kernels against their plain versions ---------------------------


def check_flash(attention, gen) -> dict:
    b, h, t, d = PATH_SHAPE
    results = {}
    cases = [
        # name, (B, H, Tq, Tk, D), dtype, causal, window, masked, tol
        ("path_f32", (b, h, t, t, d), torch.float32, False, None, True, 2e-5),
        ("bf16", (8, h, t, t, d), torch.bfloat16, False, None, True, 3e-2),
        ("causal", (8, h, t, t, d), torch.float32, True, None, True, 2e-5),
        ("causal_window", (8, h, t, t, 128), torch.float32, True, 100,
         False, 2e-5),
        ("unaligned", (4, h, 37, 41, d), torch.float32, False, None, True,
         2e-5),
        ("unaligned_bf16_causal", (4, h, 300, 300, 40), torch.bfloat16,
         True, 65, True, 3e-2),
        ("train_bf16", (32, h, 128, 128, d), torch.bfloat16, False, None,
         True, 3e-2),
        # The decoder LM's fit (bf16) and full forward (f32) at T=1024.
        ("decoder_causal_bf16", (8, h, 1024, 1024, d), torch.bfloat16, True,
         None, True, 3e-2),
        ("decoder_causal_f32", (8, h, 1024, 1024, d), torch.float32, True,
         None, True, 2e-5),
        # The MoE decoder's fit (bf16) and card-vs-CPU forward (f32): 8
        # heads of 32 at T=1024.
        ("moe_lm_causal_bf16_d32", (8, 8, 1024, 1024, 32), torch.bfloat16,
         True, None, True, 3e-2),
        ("moe_lm_causal_f32_d32", (8, 8, 1024, 1024, 32), torch.float32,
         True, None, True, 2e-5),
        # The MoE classifier's fit: 4 heads of 32 at T=256, a key mask.
        ("moe_cls_bf16_d32", (32, 4, 256, 256, 32), torch.bfloat16, False,
         None, True, 3e-2),
    ]
    for name, (bb, hh, tq, tk, dd), dtype, causal, window, masked, tol in \
            cases:
        q = torch.randn(bb, hh, tq, dd, device="cuda", generator=gen)
        k = torch.randn(bb, hh, tk, dd, device="cuda", generator=gen)
        v = torch.randn(bb, hh, tk, dd, device="cuda", generator=gen)
        q, k, v = (x.to(dtype) for x in (q, k, v))
        km = None
        if masked:
            km = torch.rand(bb, tk, device="cuda", generator=gen) > 0.25
            km[1] = False  # a fully-masked batch row
        with torch.inference_mode():
            o, lse = attention.flash_attention_fwd(q, k, v, km, causal,
                                                   window)
            # No atomics, a fixed summation order: the same bits every run.
            o2, lse2 = attention.flash_attention_fwd(q, k, v, km, causal,
                                                     window)
            torch.cuda.synchronize()
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            o_ref, lse_ref = attention.flash_attention_fwd_plain(
                q, k, v, km, causal, window)
        err_o = max_abs(o, o_ref)
        err_lse = max_abs(lse, lse_ref)
        empty_ok = True
        if masked:
            empty_ok = bool((o[1] == 0).all()) and bool((lse[1] == 1e30).all())
        ok = err_o <= tol and err_lse <= tol and empty_ok and same
        phase(f"K1 flash_fwd {name} {tuple(q.shape)} Tk={tk} "
              f"{str(dtype)[6:]}", ok,
              f"max|dO|={err_o:.3g} max|dLSE|={err_lse:.3g} "
              f"masked_row_zero_lse_1e30={empty_ok} tol={tol} "
              f"run_to_run_bitwise={same}")
        results[name] = (q, k, v, km, err_o)
    return results


def check_quant(quant, leaves, gen) -> dict:
    """K4 and K5 against their plain versions on the card, per leaf (one
    launch a matrix) and grouped (one launch over many): every quantized
    leaf of a BERT-base model, edge matrices, stochastic bits."""
    errs = {"quantize": 0.0, "dequantize": 0.0}
    bad = []
    mats = {}
    for path, leaf in leaves.items():
        x = leaf.detach().float().reshape(-1, leaf.shape[-1]).contiguous()
        v, s = quant.quantize_rowwise(x)
        v_ref, s_ref = quant.quantize_rowwise_plain(x)
        deq = quant.dequantize_rowwise(v, s)
        deq_ref = quant.dequantize_rowwise_plain(v, s)
        torch.cuda.synchronize()
        if not (torch.equal(v, v_ref) and torch.equal(s, s_ref)):
            bad.append(f"quantize {path}")
            errs["quantize"] = max(errs["quantize"], max_abs(v, v_ref))
        if not torch.equal(deq, deq_ref):
            bad.append(f"dequantize {path}")
            errs["dequantize"] = max(errs["dequantize"],
                                     max_abs(deq, deq_ref))
        mats[path] = (x, v, s)
    shapes = sorted({tuple(m[0].shape) for m in mats.values()})
    phase("K4 quantize bit-exact", not any(b.startswith("q") for b in bad),
          f"{len(mats)} BERT-base leaves, one launch each, row shapes "
          f"{shapes}; mismatches {[b for b in bad if b.startswith('q')]}")
    phase("K5 dequantize exact", not any(b.startswith("d") for b in bad),
          f"{len(mats)} leaves, one launch each; mismatches "
          f"{[b for b in bad if b.startswith('d')]}")

    # The grouped route over the whole flax tree, through the pytree
    # functions the artifact path calls (host numpy leaves).
    launches = quant.quantize_launches
    qtree = quant.quantize_pytree(leaves)
    q_launches = quant.quantize_launches - launches
    launches = quant.dequantize_launches
    back = quant.dequantize_pytree(qtree, device="cuda")
    torch.cuda.synchronize()
    d_launches = quant.dequantize_launches - launches
    g_bad = []
    for path, (x, _, _) in mats.items():
        v_ref, s_ref = quant.quantize_rowwise_plain(x)
        got = qtree[path]
        v = torch.from_numpy(got.values).cuda()
        s = torch.from_numpy(got.scales).cuda()
        if not (torch.equal(v, v_ref) and torch.equal(s, s_ref)):
            g_bad.append(f"quantize {path}")
            errs["quantize"] = max(errs["quantize"], max_abs(v, v_ref))
        deq_ref = quant.dequantize_rowwise_plain(v_ref, s_ref)
        deq = back[path].reshape(deq_ref.shape)
        if not torch.equal(deq, deq_ref):
            g_bad.append(f"dequantize {path}")
            errs["dequantize"] = max(errs["dequantize"],
                                     max_abs(deq, deq_ref))
    cap = quant.MAX_LEAVES
    want = -(-len(mats) // cap)
    phase("K4/K5 grouped over the flax tree",
          not g_bad and q_launches == d_launches == want,
          f"quantize_pytree / dequantize_pytree over {len(mats)} leaves: "
          f"{q_launches} / {d_launches} launches (expected ceil("
          f"{len(mats)}/{cap}) = {want}); mismatches {g_bad}")

    edge_ok, detail = check_quant_edges(quant, gen)
    phase("K4/K5 edge matrices", edge_ok, detail)

    # Stochastic rounding: kernel == plain (same Philox words), and the
    # mean over many seeds is unbiased.
    x = torch.randn(256, 768, device="cuda", generator=gen)
    v_k, s_k = quant.quantize_rowwise(x, stochastic=True, seed=11)
    v_p, _ = quant.quantize_rowwise_plain(x, stochastic=True, seed=11)
    same = torch.equal(v_k, v_p)
    n_seeds = 256
    acc = torch.zeros_like(x)
    for seed in range(n_seeds):
        acc += quant.dequantize_rowwise(
            *quant.quantize_rowwise(x, stochastic=True, seed=seed))
    bias = ((acc / n_seeds - x).abs() / s_k).max().item()
    det_bias = ((quant.dequantize_rowwise(*quant.quantize_rowwise(x)) - x)
                .abs() / s_k).mean().item()
    # Each draw is one of two neighbours a scale apart: the mean of 256
    # sits within 0.5/sqrt(256) = 0.031 scales per standard error; 0.2
    # allows > 6 standard errors over 196k entries.
    phase("K4 quantize stochastic", same and bias < 0.2,
          f"kernel==plain bits: {same}; max |mean-x|/scale over "
          f"{n_seeds} seeds = {bias:.4f} (deterministic mean error "
          f"{det_bias:.3f})")
    return {"mats": mats, **errs}


def quant_edge_matrices(gen) -> dict:
    """Matrices that take every row class and its edges: widths 1, 3, 33
    (scalar class), 64 (sub-warp), 3072 (a block a row), 4100 (too wide
    for registers), one row, an all-zero row, +-1e20, rows whose x/scale
    are exact halves, a source that is not 16-byte aligned, and the
    decoder LM's (768, 50257) head (odd rows 50257 wide: K4's general
    class, K5's one-element chunks) and (50257, 768) token table."""
    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    zero_row = randn(4, 96)
    zero_row[2] = 0.0
    huge = randn(6, 128) * 1e20
    halves = randn(4, 64)
    halves[:, 0] = 127.0  # scale exactly 1: the values below are ties
    halves[:, 1:9] = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                                   -126.5], device="cuda")
    return {
        "d1": randn(7, 1), "d3": randn(5, 3), "d33": randn(9, 33),
        "d64": randn(100, 64), "d3072": randn(3, 3072),
        "d4100": randn(3, 4100), "one_row": randn(1, 768),
        "zero_row": zero_row, "huge": huge, "halves": halves,
        "misaligned": randn(5 * 64 + 1)[1:].view(5, 64),
        # The decoder LM's LM head (rows 50257 wide) and token table.
        "gpt2_head": randn(768, 50257), "gpt2_embed": randn(50257, 768),
    }


def check_quant_edges(quant, gen):
    """Both routes on the edge matrices: per leaf and one grouped launch,
    deterministic and stochastic, against the plain versions bit for
    bit."""
    edges = quant_edge_matrices(gen)
    bad = []
    for name, x in edges.items():
        v, s = quant.quantize_rowwise(x)
        v_ref, s_ref = quant.quantize_rowwise_plain(x)
        if not (torch.equal(v, v_ref) and torch.equal(s, s_ref)):
            bad.append(f"per-leaf quantize {name}")
        if not torch.equal(quant.dequantize_rowwise(v, s),
                           quant.dequantize_rowwise_plain(v, s)):
            bad.append(f"per-leaf dequantize {name}")
    # int8 values that are not 16-byte aligned take K5's scalar class.
    raw = torch.randint(-127, 128, (5 * 48 + 1,), dtype=torch.int8,
                        device="cuda", generator=gen)[1:].view(5, 48)
    sc = torch.rand(5, 1, device="cuda", generator=gen)
    if not torch.equal(quant.dequantize_rowwise(raw, sc),
                       quant.dequantize_rowwise_plain(raw, sc)):
        bad.append("per-leaf dequantize misaligned int8")
    mats = list(edges.values())
    for stochastic in (False, True):
        plan, values, scales = quant._quantize_group(
            mats, stochastic=stochastic, seed=5)
        out = quant._dequantize_group(
            quant.plan_group([tuple(x.shape) for x in mats], "dequantize"),
            values, scales)
        views = quant._leaf_views(plan, values, scales)
        for (name, x), (v, s), lp in zip(edges.items(), views, plan.leaves):
            v_ref, s_ref = quant.quantize_rowwise_plain(
                x, stochastic=stochastic, seed=5)
            if not (torch.equal(v, v_ref) and torch.equal(s, s_ref)):
                bad.append(f"grouped quantize {name} stochastic="
                           f"{stochastic}")
            deq = out[lp.out_offset:lp.out_offset + lp.n * lp.d]
            if not torch.equal(deq.view(lp.n, lp.d),
                               quant.dequantize_rowwise_plain(v, s)):
                bad.append(f"grouped dequantize {name}")
    torch.cuda.synchronize()
    classes = sorted({lp.cls for lp in plan.leaves})
    return not bad, (f"{len(edges)} matrices {[tuple(x.shape) for x in mats]}"
                     f", quantize row classes {classes}, per leaf and "
                     f"grouped, deterministic and stochastic; mismatches "
                     f"{bad}")


def _random_qkv(gen, bb, hh, tq, tk, dd, dtype, masked):
    q = torch.randn(bb, hh, tq, dd, device="cuda", generator=gen)
    k = torch.randn(bb, hh, tk, dd, device="cuda", generator=gen)
    v = torch.randn(bb, hh, tk, dd, device="cuda", generator=gen)
    do = torch.randn(bb, hh, tq, dd, device="cuda", generator=gen)
    km = None
    if masked:
        km = torch.rand(bb, tk, device="cuda", generator=gen) > 0.25
        km[1] = False  # a fully-masked batch row
    return (*(x.to(dtype) for x in (q, k, v, do)), km)


def check_flash_bwd(attention, gen) -> dict:
    """K2 and K3 against their plain versions: elementwise |d| <= tol *
    (1 + |ref|) (the JAX suite's f32 grad / bf16 tolerances as atol and
    rtol), exact zeros for the fully-masked row and the masked keys."""
    b, h, t, d = TRAIN_SHAPE
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, (B, H, Tq, Tk, D), dtype, causal, window, masked, tol
        ("path_bf16", (b, h, t, t, d), bf16, False, None, True, 3e-2),
        ("path_f32", (b, h, t, t, d), f32, False, None, True, 5e-5),
        ("long_bf16", (8, h, 512, 512, d), bf16, False, None, True, 3e-2),
        ("causal", (8, h, 256, 256, d), f32, True, None, True, 5e-5),
        ("causal_window", (4, h, 256, 256, 128), f32, True, 100, False,
         5e-5),
        ("unaligned", (4, h, 37, 41, d), f32, False, None, True, 5e-5),
        ("unaligned_bf16_causal_window", (2, h, 300, 300, 40), bf16, True,
         65, True, 3e-2),
        ("causal_window_bf16_d128", (4, h, 256, 256, 128), bf16, True, 100,
         True, 3e-2),
        # The decoder LM's fit at T=1024.
        ("decoder_causal_bf16", (8, h, 1024, 1024, d), bf16, True, None,
         True, 3e-2),
        # The MoE decoder's fit: 8 heads of 32 at T=1024.
        ("moe_lm_causal_bf16_d32", (8, 8, 1024, 1024, 32), bf16, True, None,
         True, 3e-2),
        # The MoE classifier's fit: 4 heads of 32 at T=256, a key mask.
        ("moe_cls_bf16_d32", (32, 4, 256, 256, 32), bf16, False, None, True,
         3e-2),
    ]
    results = {}
    for name, (bb, hh, tq, tk, dd), dtype, causal, window, masked, tol in \
            cases:
        q, k, v, do, km = _random_qkv(gen, bb, hh, tq, tk, dd, dtype, masked)
        args = (q, k, v, km, do)
        with torch.inference_mode():
            o, lse = attention.flash_attention_fwd(q, k, v, km, causal,
                                                   window)
            delta = (do.float() * o.float()).sum(-1, keepdim=True)
            args = (*args, lse, delta, causal, window)
            got = (attention.flash_attention_bwd_dq(*args),
                   *attention.flash_attention_bwd_dkv(*args))
            # The bf16 route sums in mma fragment order, not the plain
            # version's: it must still give the same bits every run.
            same = dtype != bf16 or all(
                torch.equal(g, r) for g, r in zip(got, (
                    attention.flash_attention_bwd_dq(*args),
                    *attention.flash_attention_bwd_dkv(*args))))
            torch.cuda.synchronize()
            ref = (attention.flash_attention_bwd_dq_plain(*args),
                   *attention.flash_attention_bwd_dkv_plain(*args))
        errs = [max_abs(g, r) for g, r in zip(got, ref)]
        close = all(bool(((g.float() - r.float()).abs()
                          <= tol * (1 + r.float().abs())).all())
                    for g, r in zip(got, ref))
        zeros = True
        if masked:
            dead = ~km[0]  # masked keys of batch row 0
            zeros = all(bool((g[1] == 0).all()) for g in got) and bool(
                (got[1][0][:, dead] == 0).all()) and bool(
                (got[2][0][:, dead] == 0).all())
        phase(f"K2/K3 flash_bwd {name} {tuple(q.shape)} "
              f"Tk={tk} {str(dtype)[6:]}", close and zeros and same,
              f"max|ddQ|={errs[0]:.3g} max|ddK|={errs[1]:.3g} "
              f"max|ddV|={errs[2]:.3g} exact_zeros(masked row, masked "
              f"keys)={zeros} tol={tol}*(1+|ref|)"
              + (f" run_to_run_bitwise={same}" if dtype == bf16 else ""))
        results[name] = {"errs": errs, "args": args}
    return results


def make_train_data(vocab: int):
    """250 seeded rows at T=128 with seeded pad tails and one all-pad row;
    the label is the parity of the [CLS]-position token (learnable)."""
    rng = np.random.default_rng(7)
    t = TRAIN_SHAPE[2]
    x = rng.integers(1, vocab, (TRAIN_ROWS, t)).astype(np.int32)
    for r, n in enumerate(rng.integers(16, t + 1, TRAIN_ROWS)):
        x[r, n:] = 0
    x[3] = 0  # an all-pad row: every key masked in every layer
    return x, (x[:, 0] % 2).astype(np.int32)


def check_train_vs_cpu(est) -> dict:
    """One batch of 4 rows (one all-pad) through BERT-base in f32 on the
    card (K1/K2/K3) and on the CPU (plain versions), from the same
    weights: the loss and every parameter's gradient."""
    x, y = make_train_data(est.vocab_size)
    rows = [3, 0, 1, 2]
    return step_vs_cpu(
        est, x[rows], y[rows], "train step vs CPU plain path",
        f"BERT-base f32, rows {rows} (first all-pad) at T={x.shape[1]}")


def step_vs_cpu(est, x, y, name: str, what: str,
                dtype=torch.float32, gate: bool = True) -> dict:
    """The loss and every parameter's gradient of one batch in ``dtype``
    (f32; f64 where f32 rounding alone moves ReLU decisions, below), on
    the card and on a CPU twin of ``est`` loaded with its weights (the
    plain path), against the bars above.  ``gate=False`` reports the
    numbers without making a phase of them."""
    from learningorchestra_tpu_torch.toolkit import registry

    t0 = time.perf_counter()
    kwargs = {k: v for k, v in est.get_params().items() if k != "device"}
    cpu = registry.resolve(type(est).__module__, type(est).__name__)(
        **kwargs, device="cpu")
    cpu.load_state_dict(est.state_dict())
    loss_fn = est._loss_and_metrics("softmax_ce")

    def loss_and_grads(e):
        e.module.zero_grad(set_to_none=True)
        e.module.train().to(dtype)
        xt = torch.from_numpy(x).to(e.device)
        if xt.is_floating_point():
            xt = xt.to(dtype)
        yt = torch.from_numpy(y).to(e.device)
        loss, _ = loss_fn(e.module(xt), yt,
                          torch.ones(len(x), device=e.device, dtype=dtype))
        loss.backward()
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in e.module.named_parameters()}
        e.module.zero_grad(set_to_none=True)
        e.module.eval().to(torch.float32)
        return float(loss.detach()), grads

    loss_gpu, g_gpu = loss_and_grads(est)
    loss_cpu, g_cpu = loss_and_grads(cpu)
    cpu_s = time.perf_counter() - t0
    gmax = max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_name, bad = 0.0, "", []
    for pname, gc in g_cpu.items():
        err = float((g_gpu[pname] - gc).abs().max())
        ref = float(gc.abs().max())
        if err > GRAD_RTOL * ref + GRAD_ATOL_REL * gmax:
            bad.append(pname)
        rel = err / max(ref, GRAD_ATOL_REL * gmax)
        if rel > worst:
            worst, worst_name = rel, pname
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    report = phase if gate else (lambda n, ok, d: print(
        f"[info] {n}: {d}", flush=True))
    report(name, not bad and loss_rel <= LOSS_RTOL,
          f"{what}: loss {loss_gpu:.6f} vs {loss_cpu:.6f} (rel "
          f"{loss_rel:.2g}, tol {LOSS_RTOL}); {len(g_cpu)} gradients, worst "
          f"max|dg|/max|g| {worst:.3g} ({worst_name}); tol {GRAD_RTOL}"
          f"*max|g| + {GRAD_ATOL_REL}*{gmax:.3g}; failing {bad[:5]} (CPU "
          f"side {cpu_s:.1f}s)")
    return {"loss_rel_err": loss_rel, "worst_grad_rel_err": worst,
            "worst_grad_param": worst_name, "failing_params": len(bad)}


def run_training(est, attention) -> dict:
    """The slice's training path through the entry points a user calls:
    ``fit`` then ``evaluate``, with the kernels' counters at 0 just before
    and read just after."""
    x, y = make_train_data(est.vocab_size)
    before = [p.detach().clone() for p in est.module.parameters()]
    marks = []

    def mark_epoch(epoch, metrics, model):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    attention.launches = 0
    attention.bwd_dq_launches = 0
    attention.bwd_dkv_launches = 0
    t0 = time.perf_counter()
    est.fit(x, y, epochs=TRAIN_EPOCHS, batch_size=TRAIN_SHAPE[0],
            callbacks=[mark_epoch])
    fit_s = time.perf_counter() - t0
    evaluation = est.evaluate(x, y)
    torch.cuda.synchronize()
    counts = {"flash_fwd": attention.launches,
              "flash_bwd_dq": attention.bwd_dq_launches,
              "flash_bwd_dkv": attention.bwd_dkv_launches}

    per_epoch = -(-TRAIN_ROWS // TRAIN_SHAPE[0])
    steps = TRAIN_EPOCHS * per_epoch
    eval_batches = -(-TRAIN_ROWS // 128)
    layers = est.num_layers
    expected = {"flash_fwd": layers * (steps + eval_batches),
                "flash_bwd_dq": layers * steps,
                "flash_bwd_dkv": layers * steps}
    losses = est.history["loss"]
    finite = all(math.isfinite(v) for v in losses + [evaluation["loss"]])
    moved = sum(1 for p, p0 in zip(est.module.parameters(), before)
                if not torch.equal(p.detach(), p0))
    epoch2_ms = marks[0].elapsed_time(marks[1])
    step_ms = epoch2_ms / per_epoch
    padded_tokens = per_epoch * TRAIN_SHAPE[0] * TRAIN_SHAPE[2]
    phase("train fit", finite and moved == len(before),
          f"BertModel L={layers} H={est.hidden_dim} bf16 compute / f32 "
          f"masters, {TRAIN_ROWS} rows T={TRAIN_SHAPE[2]}, batch "
          f"{TRAIN_SHAPE[0]}, {TRAIN_EPOCHS} epochs x {per_epoch} steps: "
          f"loss {losses}, accuracy {est.history['accuracy']}, evaluate "
          f"{evaluation}; {moved}/{len(before)} parameters moved; fit "
          f"{fit_s:.2f}s (epoch_time {est.history['epoch_time']})")
    phase("train launch counters", counts == expected,
          f"{counts}; expected K1 = {layers} x ({steps} steps + "
          f"{eval_batches} evaluate batches), K2 = K3 = {layers} x {steps}")
    return {
        "counts": counts, "x": x, "y": y,
        "train": {
            "epoch2_ms": epoch2_ms, "step_ms": step_ms,
            "samples_per_s": TRAIN_ROWS / (epoch2_ms / 1e3),
            "padded_tokens_per_s": padded_tokens / (epoch2_ms / 1e3),
            "nonpad_tokens_per_s": float((x != 0).sum())
            / (epoch2_ms / 1e3),
            "losses": losses, "evaluate": evaluation,
        },
    }


def device_kernels(prof) -> dict:
    """Device ms by kernel name from a torch.profiler run.  A user
    annotation (``Optimizer.step#Adam.step``) also shows a device-side
    range spanning its kernels: it is left out, not counted twice."""
    return {
        ev.key: ev.self_device_time_total / 1e3  # us -> ms
        for ev in prof.key_averages()
        if str(ev.device_type).endswith("CUDA")
        and not getattr(ev, "is_user_annotation", False)
    }


def _family(name: str, families: dict) -> str:
    low = name.lower()
    for fam, tags in families.items():
        if any(tag in low for tag in tags):
            return fam
    return "other"


TRAIN_FAMILIES = {
    "flash_bwd_dq": ("flash_bwd_dq",), "flash_bwd_dkv": ("flash_bwd_dkv",),
    "flash_fwd": ("flash_fwd",),
    "gemm": ("gemm", "cutlass", "xmma", "cublas", "nvjet"),
    "optimizer": ("multi_tensor_apply", "adam"),
}


def profile_train_step(est, x, y) -> dict:
    """One BERT train step (a ``fit`` of one 32-row batch) by kernel
    family: :func:`profile_step`."""
    bs = TRAIN_SHAPE[0]
    return profile_step(est, x[:bs], y[:bs], TRAIN_FAMILIES)


def profile_step(est, xs, ys, families: dict,
                 batch_size: int | None = None) -> dict:
    """One ``fit`` epoch (by default of one batch: upload, permute,
    forward, backward, the optimizer, the metrics' host transfer; a
    sharded ``xs`` streams) by kernel family from torch.profiler; its
    wall time, measured apart without the profiler, gives the device's
    busy and idle share inside it."""
    from torch.profiler import ProfilerActivity, profile

    bs = batch_size or len(xs)
    est.fit(xs, ys, epochs=1, batch_size=bs)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(xs, ys, epochs=1, batch_size=bs)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        est.fit(xs, ys, epochs=1, batch_size=bs)
        torch.cuda.synchronize()
    totals = {fam: 0.0 for fam in (*families, "other")}
    kernels = device_kernels(prof)
    for name, ms in kernels.items():
        totals[_family(name, families)] += ms
    device_ms = sum(totals.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    events = prof.key_averages()
    launches = sum(ev.count for ev in events
                   if str(ev.device_type).endswith("CUDA")
                   and not getattr(ev, "is_user_annotation", False))
    host = sorted((ev for ev in events
                   if not str(ev.device_type).endswith("CUDA")),
                  key=lambda ev: -ev.self_cpu_time_total)[:8]
    return {
        "steps": -(-len(xs) // bs), "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms if device_ms else None,
        "idle_share": 1 - device_ms / wall_ms if device_ms else None,
        **{f"{k}_ms": v for k, v in totals.items()},
        "device_kernels": launches,
        "top": [[name[:60], ms] for name, ms in top],
        # Host self time under the profiler (which slows the host).
        "host_top": [[ev.key[:48], ev.count, ev.self_cpu_time_total / 1e3]
                     for ev in host],
    }


def time_bwd(attention, bwd_res) -> dict:
    """K2 and K3 in bf16 at the fine-tune shape ("train") and at (8, 12,
    512, 64) ("long"), each with a key mask with pad tails and no empty
    row, and causal with no mask at the MoE decoder's (8, 8, 1024, 32)
    ("moe_lm"): their plain versions, the backward of
    ``F.scaled_dot_product_attention`` with the same mask (its fwd+bwd
    time minus its fwd time) as the yardstick for the pair, and K1 beside
    its bound and SDPA's forward."""
    return {label: _time_bwd_at(attention, bwd_res[case]["args"], causal)
            for label, case, causal in (("train", "path_bf16", False),
                                        ("long", "long_bf16", False),
                                        ("moe_lm", "moe_lm_causal_bf16_d32",
                                         True))}


def _timing_mask(b: int, t: int, device):
    """The timed shapes' key mask: the last 37 keys of every row masked."""
    km = torch.ones(b, t, dtype=torch.bool, device=device)
    km[:, -37:] = False
    return km


def _time_bwd_at(attention, args, causal: bool = False, *,
                 plain: bool = True, reps: int = 30) -> dict:
    """See :func:`time_bwd`; ``plain=False`` leaves the plain versions
    out (``plain_ms`` None: at a long T their (B, H, T, T) f32 scores do
    not fit the card)."""
    import torch.nn.functional as F

    q, k, v, _, do, *_ = args
    b, h, t, d = q.shape
    km = None if causal else _timing_mask(b, t, q.device)
    with torch.inference_mode():
        o, lse = attention.flash_attention_fwd(q, k, v, km, causal)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        args = (q, k, v, km, do, lse, delta, causal)
        dq_ms = time_ms(lambda: attention.flash_attention_bwd_dq(*args),
                        reps=reps)
        dkv_ms = time_ms(lambda: attention.flash_attention_bwd_dkv(*args),
                         reps=reps)
        k1_ms = time_ms(
            lambda: attention.flash_attention_fwd(q, k, v, km, causal),
            reps=reps)
        dq_plain = dkv_plain = k1_plain = None
        if plain:
            dq_plain = time_ms(
                lambda: attention.flash_attention_bwd_dq_plain(*args),
                reps=3)
            dkv_plain = time_ms(
                lambda: attention.flash_attention_bwd_dkv_plain(*args),
                reps=3)
            k1_plain = time_ms(lambda: attention.flash_attention_fwd_plain(
                q, k, v, km, causal), reps=3)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    mask4 = None if causal else km[:, None, None, :]

    def lib_fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask4,
                                              is_causal=causal)

    lib_fb = time_ms(lambda: torch.autograd.grad(lib_fwd(), (qg, kg, vg),
                                                 do), reps=reps)
    lib_f = time_ms(lib_fwd, reps=reps)
    # Causal: only the live (query, key) pairs, the diagonal included.
    pairs = t * (t + 1) // 2 if causal else t * t
    elems = b * h * t * d * q.element_size()
    mask = 0 if causal else b * t * 4
    rows = 2 * b * h * t * 4 + mask  # LSE + delta, key mask
    work = {
        "dq": (6 * b * h * pairs * d, 5 * elems + rows),
        "dkv": (8 * b * h * pairs * d, 6 * elems + rows),
        # K1: q, k, v read, O written, LSE written, the key mask read.
        "k1": (4 * b * h * pairs * d, 4 * elems + b * h * t * 4 + mask),
    }
    out = {"shape": [b, h, t, d], "causal": causal,
           "library_bwd_ms": lib_fb - lib_f,
           "library_fwd_bwd_ms": lib_fb, "library_fwd_ms": lib_f}
    for key, ms, plain in (("dq", dq_ms, dq_plain), ("dkv", dkv_ms,
                                                        dkv_plain),
                           ("k1", k1_ms, k1_plain)):
        flops, nbytes = work[key]
        by_ops = flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
        out[key] = {
            "ms": ms, "plain_ms": plain, "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(flops / PEAK_BF16_FLOPS,
                                  nbytes / PEAK_BYTES),
            "bound_by": "operations" if by_ops else "bytes",
        }
    return out


# -- phase 4: the slice ------------------------------------------------------


def request(port, verb, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(verb, "/api/learningOrchestra/v1" + path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def server_config(tmp):
    """The port's server config with its store and volumes under ``tmp``
    (the volumes at ``tmp`` itself, where the phases save artifacts)."""
    from learningorchestra_tpu_torch.config import Config, StoreConfig

    return Config(store=StoreConfig(root=f"{tmp}/store", volume_root=tmp))


def make_requests(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(2024)
    reqs = []
    for i in range(N_REQUESTS):
        rows = int(rng.integers(1, 9))
        x = rng.integers(1, vocab, (rows, SEQ_LEN)).astype(np.int32)
        for r in range(rows):
            x[r, int(rng.integers(16, SEQ_LEN + 1)):] = 0  # pad tail
        reqs.append(x)
    reqs[5][0] = 0  # an all-pad row: every key masked in every layer
    return reqs


def run_slice(est, tmp) -> dict:
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.ops import attention, quant
    from learningorchestra_tpu_torch.ops.quant import QuantizedLeaf
    from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE
    from learningorchestra_tpu_torch.store.volumes import VolumeStorage
    from learningorchestra_tpu_torch.train.neural import load_artifact

    reqs = make_requests(est.vocab_size)
    volumes = VolumeStorage(tmp)
    cfg = server_config(tmp)

    # Main path: counters at 0 just before, read just after.
    attention.launches = 0
    quant.quantize_launches = quant.quantize_leaves = 0
    quant.dequantize_launches = quant.dequantize_leaves = 0
    t0 = time.perf_counter()
    artifact = est.to_artifact(quantize=True)
    volumes.save_object(ARTIFACT_TYPE, "bert-base", artifact)
    save_s = time.perf_counter() - t0
    server = APIServer(cfg, device="cuda")
    port = server.start_background()
    try:
        t0 = time.perf_counter()
        status, body = request(port, "POST", "/serve/bert-base/load")
        load_s = time.perf_counter() - t0
        phase("slice load", status == 200,
              f"POST /serve/bert-base/load -> {status} "
              f"{body.get('result', body)} in {load_s:.2f}s "
              f"(artifact save {save_s:.2f}s)")
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(N_REQUESTS) as pool:
            answers = list(pool.map(
                lambda x: request(port, "POST", "/serve/bert-base/predict",
                                  {"instances": x.tolist()}), reqs))
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = {
            "flash_fwd": attention.launches,
            "quantize_rowwise": quant.quantize_launches,
            "dequantize_rowwise": quant.dequantize_launches,
            "quantize_leaves": quant.quantize_leaves,
            "dequantize_leaves": quant.dequantize_leaves,
        }
        status, listing = request(port, "GET", "/serve")
    finally:
        server.shutdown()

    stats = listing["stats"]["models"]["bert-base"]
    preds = []
    ok = True
    for x, (st, body) in zip(reqs, answers):
        p = np.asarray(body.get("predictions", []), np.float32)
        ok &= st == 200 and p.shape == (len(x), 2) and bool(
            np.isfinite(p).all())
        preds.append(p)
    rows = sum(len(x) for x in reqs)
    lat = sorted(b.get("latencyMs", 0.0) for _, b in answers)
    phase("slice predict", ok,
          f"{len(reqs)} concurrent requests, {rows} rows of T={SEQ_LEN}: "
          f"statuses {sorted({s for s, _ in answers})}, shapes (rows, 2), "
          f"finite; {stats['batches']} dispatches, buckets "
          f"{stats['bucketHistogram']}, wall {wall_s:.3f}s")

    n_quant = sum(1 for _ in _leaves_of(artifact["state"]["params"],
                                        QuantizedLeaf))
    dispatches = stats["batches"]
    # One grouped launch per direction takes up to MAX_LEAVES leaves.
    n_launch = -(-n_quant // quant.MAX_LEAVES)
    phase("launch counters", counts["flash_fwd"] == 12 * dispatches
          and counts["dequantize_rowwise"] == n_launch
          and counts["quantize_rowwise"] == n_launch
          and counts["quantize_leaves"] == n_quant
          and counts["dequantize_leaves"] == n_quant,
          f"{counts}; expected flash 12 x {dispatches} dispatches = "
          f"{12 * dispatches}, quantize = dequantize = ceil({n_quant}/"
          f"{quant.MAX_LEAVES}) = {n_launch} launches over {n_quant} "
          f"leaves")

    # The same artifact on the CPU (plain attention, plain dequantize).
    picks = [(5, 0), (0, 0), (7, len(reqs[7]) - 1)]
    x_cpu = np.stack([reqs[i][r] for i, r in picks])
    t0 = time.perf_counter()
    ref = load_artifact(artifact, device="cpu").predict(x_cpu)
    cpu_s = time.perf_counter() - t0
    got = np.stack([preds[i][r] for i, r in picks])
    err = float(np.abs(got - ref).max())
    phase("slice vs CPU plain path", err <= CPU_ATOL,
          f"rows {picks} (first is all-pad): max|dlogit|={err:.3g} "
          f"atol={CPU_ATOL} (CPU {cpu_s:.1f}s)")
    return {
        "counts": counts,
        "serve": {
            "requests": len(reqs), "rows": rows, "dispatches": dispatches,
            "buckets": stats["bucketHistogram"], "wall_s": wall_s,
            "rows_per_s": rows / wall_s,
            "latency_ms_p50": lat[len(lat) // 2], "latency_ms_max": lat[-1],
            "artifact_save_s": save_s, "load_s": load_s,
            "cpu_max_abs_err": err,
        },
        "artifact": artifact,
    }


def cold_start(est, tmp) -> dict:
    """The artifact save and load of the slice replayed part by part, with
    ``torch.cuda.synchronize()`` between parts (wall ms each), beside the
    whole calls.  Save: the flax tree and the contiguous f32 copies ahead
    of K4, K4's grouped launch, the two device-to-host copies, the host
    copies of the leaves that stay full precision, the rest of
    ``to_artifact``, pickling.  Load:
    reading and unpickling, building the estimator (module, seeded CPU
    init, ``.to(device)``), uploading the int8 leaves, K5's grouped
    launch, ``load_state_dict``.  The upload is measured two ways, in
    turns: leaf by leaf into slices of the device buffers (what the port
    does), and staged once through pinned host memory."""
    from learningorchestra_tpu_torch import convert
    from learningorchestra_tpu_torch.ops import quant
    from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE
    from learningorchestra_tpu_torch.store.volumes import VolumeStorage
    from learningorchestra_tpu_torch.toolkit import registry
    from learningorchestra_tpu_torch.train.neural import (
        init_params,
        load_artifact,
    )

    volumes = VolumeStorage(tmp)
    clock = {"t": 0.0}

    def lap() -> float:
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms, clock["t"] = (now - clock["t"]) * 1e3, now
        return ms

    def pick(leaf):
        return quant._quantizable(leaf, quant._QUANT_MIN_ELEMENTS)

    save, load = {}, {}
    lap()
    artifact = est.to_artifact(quantize=True)
    save["to_artifact_ms"] = lap()
    volumes.save_object(ARTIFACT_TYPE, "cold", artifact)
    save["pickle_write_ms"] = lap()
    _, found = quant._collect(convert.flax_tree(est.module), pick)
    mats = [quant._as_matrix(leaf) for leaf in found]
    save["flax_tree_and_contiguous_ms"] = lap()
    plan, values, scales = quant._quantize_group(mats)
    save["k4_launch_ms"] = lap()
    values.cpu().numpy(), scales.cpu().numpy()
    save["device_to_host_ms"] = lap()
    _, small = quant._collect(convert.flax_tree(est.module),
                              lambda x: not pick(x))
    lap()
    [convert.to_host(t) for t in small]
    save["small_leaves_to_host_ms"] = lap()
    save["small_leaves"] = len(small)
    save["rest_of_to_artifact_ms"] = save["to_artifact_ms"] - sum(
        save[k] for k in ("flax_tree_and_contiguous_ms", "k4_launch_ms",
                          "device_to_host_ms", "small_leaves_to_host_ms"))
    del mats, values, scales

    lap()
    load_artifact(volumes.read_object(ARTIFACT_TYPE, "cold"),
                  device="cuda")
    load["load_artifact_ms"] = lap()
    doc = volumes.read_object(ARTIFACT_TYPE, "cold")
    load["read_unpickle_ms"] = lap()
    cls = registry.resolve(doc["modulePath"], doc["class"])
    fresh = cls(**doc["classParameters"], device="cuda")
    load["construct_ms"] = lap()
    cpu_est = cls(**doc["classParameters"], device="cpu")
    load["construct_cpu_only_ms"] = lap()
    init_params(cpu_est.module, cpu_est.seed)
    load["of_which_seeded_cpu_init_ms"] = lap()
    cpu_est.module.to("cuda")
    load["of_which_to_device_ms"] = lap()
    del cpu_est
    state = doc["state"]
    shell, found = quant._collect(state["params"],
                                  lambda x: isinstance(x, quant.QuantizedLeaf))
    plan = quant.plan_group(quant._quantized_shapes(found), "dequantize")
    load["collect_and_plan_ms"] = lap()
    uploads = {"leaf_by_leaf_ms": [], "pinned_staging_ms": []}
    for way in ("leaf_by_leaf_ms", "pinned_staging_ms", "pinned_staging_ms",
                "leaf_by_leaf_ms"):
        lap()
        if way == "leaf_by_leaf_ms":
            values, scales = quant._upload(found, plan, "cuda")
        else:
            values, scales = _upload_pinned(quant, found, plan)
        uploads[way].append(lap())
    load["upload_ms"] = uploads
    out = quant._dequantize_group(plan, values, scales)
    load["k5_launch_ms"] = lap()
    params = quant._fill(shell, [
        out[lp.out_offset:lp.out_offset + lp.n * lp.d].view(leaf.shape)
        for leaf, lp in zip(found, plan.leaves)])
    fresh.load_state_dict({**state, "params": params})
    load["load_state_dict_ms"] = lap()
    return {"save": save, "load": load, "artifact_bytes": _tree_bytes(tmp)}


def _upload_pinned(quant, found, plan):
    """The other way to upload: pack the leaves into pinned host buffers,
    then one host-to-device copy of each."""
    values = torch.empty(plan.values_bytes, dtype=torch.int8,
                         pin_memory=True)
    scales = torch.empty(plan.scales_count, dtype=torch.float32,
                         pin_memory=True)
    for leaf, lp in zip(found, plan.leaves):
        values[lp.values_offset:lp.values_offset + lp.n * lp.d].copy_(
            quant._host_tensor(leaf.values, np.int8))
        scales[lp.scales_offset:lp.scales_offset + lp.n].copy_(
            quant._host_tensor(leaf.scales, np.float32))
    return (values.to("cuda", non_blocking=True),
            scales.to("cuda", non_blocking=True))


def _tree_bytes(root) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def _leaves_of(tree, cls):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves_of(v, cls)
    elif isinstance(tree, cls):
        yield tree


# -- phase 5: timings --------------------------------------------------------


def time_fwd_f32(attention, q, k, v) -> dict:
    """K1's f32 route at the serving shape with a key mask with pad tails
    and no empty row: kernel, plain version and the forward of
    ``F.scaled_dot_product_attention`` with the same boolean mask, and the
    bound: the bytes (q, k, v read, O and LSE written, the mask read)
    against three TF32 products per f32 product (split TF32)."""
    import torch.nn.functional as F

    b, h, t, d = q.shape
    km = torch.ones(b, t, dtype=torch.bool, device="cuda")
    km[:, -37:] = False
    mask4 = km[:, None, None, :]
    with torch.inference_mode():
        flash_ms = time_ms(lambda: attention.flash_attention_fwd(q, k, v,
                                                                    km))
        plain_ms = time_ms(lambda: attention.flash_attention_fwd_plain(
            q, k, v, km), reps=3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask4))
    flops = 4 * b * h * t * t * d
    nbytes = 4 * (4 * q.numel()) + 4 * km.numel() + 4 * b * h * t
    by_ops = 3 * flops / PEAK_TF32_FLOPS >= nbytes / PEAK_BYTES
    return {
        "shape": [b, h, t, d], "ms": flash_ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
        "bound_ms": 1e3 * max(3 * flops / PEAK_TF32_FLOPS,
                              nbytes / PEAK_BYTES),
        "bound_by": "operations" if by_ops else "bytes",
    }


def sdpa_kernel_names(q, k, v) -> list:
    """The device kernels of one f32 ``scaled_dot_product_attention`` call
    with a boolean key mask (the yardstick's method, by name)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    km = torch.ones(q.shape[0], k.shape[2], dtype=torch.bool, device="cuda")
    km[:, -37:] = False
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, attn_mask=km[:, None, None])
        torch.cuda.synchronize()
    return sorted(device_kernels(prof))


def time_quant_per_leaf(quant, mats) -> dict:
    """What every version of K4/K5 has: one ``quantize_rowwise`` /
    ``dequantize_rowwise`` launch per leaf over all of ``mats`` ((x,
    values, scales) on the card), as device time (behind a device sleep)
    and paced by the host, and the wall time of ``quantize_pytree`` /
    ``dequantize_pytree`` over the same leaves (host copies included)."""
    def each(fn):
        return lambda: [fn(*args) for args in mats]

    tree = {f"leaf{i}": x for i, (x, _, _) in enumerate(mats)}
    qtree = quant.quantize_pytree(tree)

    def wall_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    quant_each = each(lambda x, v, s: quant.quantize_rowwise(x))
    deq_each = each(lambda x, v, s: quant.dequantize_rowwise(v, s))
    return {
        "quantize_per_leaf_ms": time_ms(quant_each, reps=5),
        "dequantize_per_leaf_ms": time_ms(deq_each, reps=5),
        "quantize_per_leaf_host_paced_ms": time_ms(quant_each, reps=5,
                                                   hide_launch=False),
        "dequantize_per_leaf_host_paced_ms": time_ms(deq_each, reps=5,
                                                     hide_launch=False),
        "quantize_pytree_wall_ms": wall_ms(lambda: quant.quantize_pytree(
            tree)),
        "dequantize_pytree_wall_ms": wall_ms(
            lambda: quant.dequantize_pytree(qtree, device="cuda")),
    }


def time_quant(quant, quant_mats) -> dict:
    """K4 and K5 over every quantized leaf of the artifact (548.5 MB for
    BERT-base): the grouped launch (device time and host-paced), the
    per-leaf launches, the plain versions, ``torch.mul(int8, f32)`` as
    K5's library call, and K4's stochastic route at the Dense_0 shape."""
    mats = list(quant_mats.values())
    xs = [x for x, _, _ in mats]
    out = {**time_quant_group(quant, xs),
           **time_quant_per_leaf(quant, mats)}
    # Stochastic K4 (one Philox call per 4 columns) at the Dense_0 shape
    # (768 x 3072), beside the deterministic route at the same shape.
    x = next(x for x in xs if tuple(x.shape) == (768, 3072))
    out["dense0"] = {
        "shape": list(x.shape),
        "bound_ms": 1e3 * (x.numel() * 5 + x.shape[0] * 4) / PEAK_BYTES,
        "deterministic_ms": time_ms(lambda: quant.quantize_rowwise(x),
                                    reps=50),
        "stochastic_ms": time_ms(
            lambda: quant.quantize_rowwise(x, stochastic=True, seed=3),
            reps=50),
    }
    return out


def time_quant_group(quant, xs) -> dict:
    """K4 and K5 over the matrices ``xs`` (every quantized leaf of an
    artifact, f32 on the card) in their grouped launches, device time and
    host-paced, beside the plain versions, ``torch.mul(int8, f32)`` as
    K5's library call, and the bytes bound: each f32 element read and
    its int8 written once, and one f32 scale a row."""
    q_bytes = sum(x.numel() * 5 + x.shape[0] * 4 for x in xs)
    _, values, scales = quant._quantize_group(xs)
    plan = quant.plan_group([tuple(x.shape) for x in xs], "dequantize")
    pairs = [quant.quantize_rowwise_plain(x) for x in xs]

    def group_q():
        quant._quantize_group(xs)

    def group_dq():
        quant._dequantize_group(plan, values, scales)

    return {
        "bytes": q_bytes, "bound_ms": 1e3 * q_bytes / PEAK_BYTES,
        "leaves": len(xs), "launches_per_group": plan.launches,
        "quantize_grouped_ms": time_ms(group_q, reps=20),
        "dequantize_grouped_ms": time_ms(group_dq, reps=20),
        "quantize_grouped_host_paced_ms": time_ms(group_q, reps=20,
                                                  hide_launch=False),
        "dequantize_grouped_host_paced_ms": time_ms(group_dq, reps=20,
                                                    hide_launch=False),
        "quantize_plain_ms": time_ms(
            lambda: [quant.quantize_rowwise_plain(x) for x in xs], reps=3),
        "dequantize_plain_ms": time_ms(
            lambda: [quant.dequantize_rowwise_plain(v, s)
                     for v, s in pairs], reps=3),
        "dequantize_library_ms": time_ms(
            lambda: [torch.mul(v, s) for v, s in pairs], reps=5),
    }


def time_zoo_quant(est) -> dict:
    """:func:`time_quant_group` over a trained model's quantized leaves
    (the ResNet-50 artifact's), as ``quantize_pytree`` collects them."""
    from learningorchestra_tpu_torch.ops import quant

    _, found = quant._collect(
        convert_tree(est),
        lambda x: quant._quantizable(x, quant._QUANT_MIN_ELEMENTS))
    return time_quant_group(quant, [quant._as_matrix(x) for x in found])


def run_vision_slice(est, x, tmp) -> dict:
    """The trained MnistCNN as an int8 artifact served by the port's REST
    server on the card: ``POST /serve/mnist-cnn/load`` (K5, one grouped
    launch) and a burst of concurrent predicts of 1-16 images; every
    answer 200, (rows, 10), finite, sampled rows against the same
    artifact on the CPU."""
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.ops import quant
    from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE
    from learningorchestra_tpu_torch.store.volumes import VolumeStorage
    from learningorchestra_tpu_torch.train.neural import load_artifact

    rng = np.random.default_rng(2025)
    reqs = [x[rng.integers(0, len(x), int(rng.integers(1, 17)))]
            for _ in range(N_VISION_REQUESTS)]
    volumes = VolumeStorage(tmp)
    artifact = est.to_artifact(quantize=True)
    volumes.save_object(ARTIFACT_TYPE, "mnist-cnn", artifact)
    server = APIServer(server_config(tmp), device="cuda")
    port = server.start_background()
    try:
        quant.dequantize_launches = 0
        t0 = time.perf_counter()
        status, body = request(port, "POST", "/serve/mnist-cnn/load")
        load_s = time.perf_counter() - t0
        k5 = quant.dequantize_launches
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
            answers = list(pool.map(
                lambda xr: request(port, "POST", "/serve/mnist-cnn/predict",
                                   {"instances": xr.tolist()}), reqs))
        wall_s = time.perf_counter() - t0
        _, listing = request(port, "GET", "/serve")
    finally:
        server.shutdown()
    stats = listing["stats"]["models"]["mnist-cnn"]
    preds, ok = [], status == 200 and k5 == 1
    for xr, (st, b) in zip(reqs, answers):
        p = np.asarray(b.get("predictions", []), np.float32)
        ok &= st == 200 and p.shape == (len(xr), 10) and bool(
            np.isfinite(p).all())
        preds.append(p)
    picks = [(0, 0), (5, len(reqs[5]) - 1), (11, 0)]
    ref = load_artifact(artifact, device="cpu").predict(
        np.stack([reqs[i][r] for i, r in picks]))
    err = float(np.abs(np.stack([preds[i][r] for i, r in picks])
                       - ref).max())
    rows = sum(len(xr) for xr in reqs)
    lat = sorted(b.get("latencyMs", 0.0) for _, b in answers)
    phase("vision slice", ok and err <= CPU_ATOL,
          f"POST /serve/mnist-cnn/load -> {status} in {load_s:.2f}s (K5 "
          f"launches {k5}, expected 1); {len(reqs)} concurrent predicts, "
          f"{rows} images: statuses {sorted({st for st, _ in answers})}, "
          f"shapes (rows, 10), finite; {stats['batches']} dispatches, "
          f"buckets {stats['bucketHistogram']}, wall {wall_s:.3f}s; rows "
          f"{picks} vs the CPU: max|dlogit| {err:.3g} (atol {CPU_ATOL})")
    return {"requests": len(reqs), "rows": rows, "wall_s": wall_s,
            "rows_per_s": rows / wall_s, "load_s": load_s,
            "dispatches": stats["batches"],
            "buckets": stats["bucketHistogram"],
            "latency_ms_p50": lat[len(lat) // 2], "latency_ms_max": lat[-1],
            "cpu_max_abs_err": err, "k5_launches": k5}


def time_kernels(flash_inputs, quant_mats, est) -> dict:
    from learningorchestra_tpu_torch.ops import attention, quant

    q, k, v, _, _ = flash_inputs["path_f32"]
    b = q.shape[0]
    fwd = time_fwd_f32(attention, q, k, v)
    quant_t = time_quant(quant, quant_mats)

    # One full serving bucket through the model, for the layer breakdown.
    x = torch.randint(1, est.vocab_size, (b, SEQ_LEN), device="cuda")
    with torch.inference_mode():
        forward_ms = time_ms(lambda: est.module(x), reps=5)
    return {"flash": fwd, "quant": quant_t, "forward_ms": forward_ms}


def profile_forward(est) -> dict:
    """Device time of one 64-row bucket through the model, by kernel
    family, from torch.profiler (CUPTI); the forward's wall time from CUDA
    events gives the device's idle share inside one dispatch."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randint(1, est.vocab_size, (PATH_SHAPE[0], SEQ_LEN),
                      device="cuda")
    with torch.inference_mode():
        forward_ms = time_ms(lambda: est.module(x), reps=1,
                             hide_launch=False)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            est.module(x)
            torch.cuda.synchronize()
    kernels = device_kernels(prof)
    families = {"flash_fwd": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        fam = "flash_fwd" if "flash_fwd" in low else "gemm" if any(
            tag in low for tag in ("gemm", "cutlass", "xmma", "cublas")
        ) else "other"
        families[fam] += ms
    device_ms = sum(families.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {
        "forward_ms": forward_ms, "device_ms": device_ms,
        "idle_share": 1 - device_ms / forward_ms if device_ms else None,
        **{f"{k}_ms": v for k, v in families.items()},
        "top": [[name[:60], ms] for name, ms in top],
    }


# -- phase 7: the vision zoo and the LSTM (BASELINE configs 2, 3, 5) --------

# The JAX package's bench shapes (bench.py FULL_SUITE): MNIST-shaped
# (16384, 28, 28, 1) at batch 1024; ResNet-50 at (512, 224, 224, 3), batch
# 64, 1000 classes.  The LSTM at the Keras IMDb LSTM example's shape
# (max_features 20000, maxlen 80, batch 32: LSTMClassifier's defaults).
ZOO = {
    "vision": dict(rows=16384, batch=1024, epochs=4, cpu_rows=16),
    "resnet50": dict(rows=512, batch=64, epochs=2, cpu_rows=8),
    "lstm": dict(rows=2048, batch=32, epochs=3, cpu_rows=32),
}
LSTM_T = 80
ZOO_FAMILIES = {  # by kernel name, first match wins
    "conv": ("fprop", "dgrad", "wgrad", "conv", "implicit", "winograd"),
    "layout": ("nchwtonhwc", "nhwctonchw"),
    "lstm": ("lstm", "rnn"),
    "gemm": ("gemm", "cutlass", "xmma", "cublas", "nvjet"),
    "norm": ("norm", "moments", "fusedparams", "internalgradients",
             "gammabeta"),
    "pool": ("pool",),
    "optimizer": ("multi_tensor_apply", "adam"),
}
N_VISION_REQUESTS = 24


def make_zoo_data(kind: str):
    """Seeded inputs: MNIST-shaped images with a class-coded bright band
    (learnable), ResNet-50 images with random labels, and token rows of
    T=80 with seeded pad tails and one all-pad row (label: the first
    token's parity)."""
    rng = np.random.default_rng({"vision": 11, "resnet50": 12,
                                 "lstm": 13}[kind])
    n = ZOO[kind]["rows"]
    if kind == "vision":
        y = rng.integers(0, 10, n).astype(np.int32)
        x = rng.random((n, 28, 28, 1), dtype=np.float32) * 0.5
        for c in range(10):
            x[y == c, 2 * c + 3:2 * c + 6] += 0.5
        return x, y
    if kind == "resnet50":
        x = rng.standard_normal((n, 224, 224, 3), dtype=np.float32)
        return x, rng.integers(0, 1000, n).astype(np.int32)
    x = rng.integers(1, 20000, (n, LSTM_T)).astype(np.int32)
    for r, keep in enumerate(rng.integers(8, LSTM_T + 1, n)):
        x[r, keep:] = 0
    x[3] = 0
    return x, (x[:, 0] % 2).astype(np.int32)


def build_zoo(kind: str):
    from learningorchestra_tpu_torch.models.text import LSTMClassifier
    from learningorchestra_tpu_torch.models.vision import MnistCNN, ResNet50

    cls = {"vision": MnistCNN, "resnet50": ResNet50,
           "lstm": LSTMClassifier}[kind]
    return cls(seed=0, device="cuda")


def run_zoo(kind: str) -> dict:
    """One model of the zoo through the entry points a user calls: built
    at its first input, one f32 batch on the card against the CPU, then
    ``fit`` (bf16 on f32 masters for the CNNs, f32 for the LSTM) with a
    CUDA event at every epoch's end; steady samples/s over epochs 2..N."""
    cfg = ZOO[kind]
    x, y = make_zoo_data(kind)
    est = build_zoo(kind)
    t0 = time.perf_counter()
    est._init_params(x[:1])
    build_s = time.perf_counter() - t0
    k = cfg["cpu_rows"]
    what = f"{type(est).__name__}, {k} rows of {x.shape[1:]}"
    if kind == "resnet50":
        # 50 ReLU layers: f32 rounding alone flips a few of ResNet-50's
        # millions of ReLU decisions (a CPU f32 pass against a CPU f64
        # pass: 1-8 per block output, 154 of 161 gradients off the bar by
        # up to 2.8 %), and a flipped decision moves its gradient element
        # by its whole value.  So the card is held to the CPU in f64 at
        # the same bars; the f32 numbers are reported beside them.
        f32 = step_vs_cpu(est, x[:k], y[:k], f"{kind} f32 step vs CPU",
                          what + " f32", gate=False)
        grad = step_vs_cpu(est, x[:k], y[:k], f"{kind} step vs CPU plain "
                           "path", what + " f64", dtype=torch.float64)
        grad["f32"] = f32
    else:
        grad = step_vs_cpu(est, x[:k], y[:k],
                           f"{kind} step vs CPU plain path", what + " f32")
    before = [p.detach().clone() for p in est.module.parameters()]
    marks = []

    def mark_epoch(epoch, metrics, model):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    t0 = time.perf_counter()
    est.fit(x, y, epochs=cfg["epochs"], batch_size=cfg["batch"],
            callbacks=[mark_epoch])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    per_epoch = -(-cfg["rows"] // cfg["batch"])
    steady_ms = marks[0].elapsed_time(marks[-1])
    steady_steps = (cfg["epochs"] - 1) * per_epoch
    losses = est.history["loss"]
    moved = sum(1 for p, p0 in zip(est.module.parameters(), before)
                if not torch.equal(p.detach(), p0))
    finite = all(math.isfinite(v) for v in losses)
    res = {
        "model": type(est).__name__, "compute_dtype": est.compute_dtype,
        "rows": cfg["rows"], "batch": cfg["batch"], "epochs": cfg["epochs"],
        "steps_per_epoch": per_epoch,
        "samples_per_s": (cfg["epochs"] - 1) * cfg["rows"]
        / (steady_ms / 1e3),
        "step_ms": steady_ms / steady_steps, "fit_s": fit_s,
        "build_s": build_s, "losses": losses,
        "accuracy": est.history["accuracy"],
        "epoch_time": est.history["epoch_time"],
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        **grad,
    }
    phase(f"{kind} train", finite and moved == len(before),
          f"{res['model']} {est.compute_dtype} compute, {cfg['rows']} rows "
          f"of {x.shape[1:]}, batch {cfg['batch']}, {cfg['epochs']} epochs "
          f"x {per_epoch} steps: loss {losses}, accuracy {res['accuracy']}; "
          f"{moved}/{len(before)} parameters moved; steady "
          f"{res['samples_per_s']:.0f} samples/s, {res['step_ms']:.3f} ms "
          f"a step (epochs 2-{cfg['epochs']}, CUDA events); fit "
          f"{fit_s:.2f}s")
    try:
        res["profile"] = profile_step(est, x[:cfg["batch"]],
                                      y[:cfg["batch"]], ZOO_FAMILIES)
    except Exception as exc:  # noqa: BLE001 — where CUPTI tracing is
        # unavailable this breakdown is reported as not measured.
        res["profile"] = {"not_measured": repr(exc)}
    return {"est": est, "x": x, "y": y, "result": res}


def artifact_leaves(art: dict, live, loaded) -> dict:
    """Every leaf of an artifact's params against the estimator ``live``
    it was saved from and the estimator ``loaded`` from it: an int8
    leaf's bits against the plain K4 of the live f32 leaf flattened to
    (-1, last), its loaded values against the plain K5 of those bits; a
    leaf left f32 (under the 4,096-element floor) loaded bit-equal to the
    live one.  Returns the int8 leaves' names and (rows, d), the f32
    leaves' names, the failing names and the largest differences."""
    from learningorchestra_tpu_torch.ops import quant
    from learningorchestra_tpu_torch.ops.quant import QuantizedLeaf

    live_tree = dict(_flat(convert_tree(live)))
    back_tree = dict(_flat(convert_tree(loaded)))
    out = {"int8": [], "f32": [], "bad": [],
           "max_abs_err": {"quantize": 0.0, "dequantize": 0.0}}
    for key, leaf in _flat(art["state"]["params"]):
        name = "/".join(key)
        want = live_tree[key].detach()
        got = back_tree[key].detach()
        if not isinstance(leaf, QuantizedLeaf):
            out["f32"].append(name)
            if not torch.equal(got, want):
                out["bad"].append(name)
            continue
        shape = leaf.values.shape
        out["int8"].append((name, shape))
        v_ref, s_ref = quant.quantize_rowwise_plain(
            want.float().reshape(shape).contiguous())
        v = torch.from_numpy(leaf.values).to(want.device)
        s = torch.from_numpy(leaf.scales).to(want.device)
        deq_ref = quant.dequantize_rowwise_plain(v, s)
        deq = got.float().reshape(deq_ref.shape)
        err = out["max_abs_err"]
        err["quantize"] = max(err["quantize"], max_abs(v, v_ref),
                              max_abs(s, s_ref))
        err["dequantize"] = max(err["dequantize"], max_abs(deq, deq_ref))
        if not (torch.equal(v, v_ref) and torch.equal(s, s_ref)
                and torch.equal(deq, deq_ref)):
            out["bad"].append(name)
    return out


def zoo_artifacts(zoo: dict) -> dict:
    """Each trained model saved with ``to_artifact(quantize=True)`` (K4:
    one grouped launch a save) and loaded back on the card (K5: one a
    load), counters at 0 just before each and read just after; every
    leaf held by :func:`artifact_leaves`, each int8 leaf's (rows, d)
    and the row class its grouped launch gave it; predictions of the
    loaded artifact against the same artifact on the CPU."""
    from learningorchestra_tpu_torch.ops import quant
    from learningorchestra_tpu_torch.train.neural import load_artifact

    classes = {quant.SUBWARP: "SUBWARP", quant.WARP: "WARP",
               quant.BLOCK: "BLOCK", quant.GENERAL: "GENERAL"}
    out = {"launches": {"quantize_rowwise": 0, "dequantize_rowwise": 0},
           "max_abs_err": {"quantize": 0.0, "dequantize": 0.0}}
    for kind, run in zoo.items():
        est = run["est"]
        quant.quantize_launches = quant.quantize_leaves = 0
        t0 = time.perf_counter()
        art = est.to_artifact(quantize=True)
        save_s = time.perf_counter() - t0
        q = (quant.quantize_launches, quant.quantize_leaves)
        quant.dequantize_launches = quant.dequantize_leaves = 0
        t0 = time.perf_counter()
        loaded = load_artifact(art, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        d = (quant.dequantize_launches, quant.dequantize_leaves)
        out["launches"]["quantize_rowwise"] += q[0]
        out["launches"]["dequantize_rowwise"] += d[0]

        held = artifact_leaves(art, est, loaded)
        leaves, bad = held["int8"], held["bad"]
        shapes = [shape for _, shape in leaves]
        plan = quant.plan_group(shapes, "quantize")
        for key in ("quantize", "dequantize"):
            out["max_abs_err"][key] = max(out["max_abs_err"][key],
                                          held["max_abs_err"][key])
        want = -(-len(leaves) // quant.MAX_LEAVES)
        rows = np.arange(0, len(run["x"]), max(1, len(run["x"]) // 6))[:6]
        xs = run["x"][rows]
        got = loaded.predict(xs)
        t0 = time.perf_counter()
        ref = load_artifact(art, device="cpu").predict(xs)
        cpu_s = time.perf_counter() - t0
        err = float(np.abs(got - ref).max())
        table = [[name, list(shape), classes[lp.cls]]
                 for (name, _), shape, lp in zip(leaves, shapes,
                                                  plan.leaves)]
        out[kind] = {"leaves": table, "save_s": save_s, "load_s": load_s,
                     "k4": q, "k5": d, "cpu_max_abs_err": err,
                     "bit_mismatches": bad}
        phase(f"{kind} artifact", not bad and q == d == (want, len(leaves))
              and err <= CPU_ATOL,
              f"{type(est).__name__}: {len(leaves)} int8 leaves and "
              f"{len(held['f32'])} f32, K4 (launches, leaves) {q}, K5 {d}, "
              f"expected ({want}, {len(leaves)}); int8 bits vs plain K4/K5 "
              f"on the card, f32 leaves loaded unchanged: mismatches "
              f"{bad[:4]}; save {save_s:.3f}s load {load_s:.3f}s; "
              f"predict rows {rows.tolist()} vs the CPU: max|d| {err:.3g} "
              f"(atol {CPU_ATOL}, CPU {cpu_s:.1f}s)")
        print(f"  {kind} leaves (rows, d) and K4 row class: "
              + json.dumps(table), flush=True)
    return out


# -- phase 8: the REST pipeline (named, lineage-tracked async jobs) -----------

# The REST fine-tune runs the training phase's data and shape through the
# port's APIServer: BERT-base at max_len 128, batch 32, 2 epochs.
REST_FIELDS = [f"t{i}" for i in range(TRAIN_SHAPE[2])]
# BERT-base (the class's defaults: L=12, H=768, A=12, vocab 30522).
REST_MODEL = {"max_len": TRAIN_SHAPE[2], "num_classes": 2,
              "learning_rate": 2e-5}
REST_LAYERS = 12
REST_CPU_ROWS = [3, 0, 1, 2, 4, 5, 6, 7]  # row 3 is all pad


def kernel_counts() -> dict:
    """Every kernel's launch counter, read after the card is idle."""
    from learningorchestra_tpu_torch.ops import attention, quant

    torch.cuda.synchronize()
    return {"flash_fwd": attention.launches,
            "flash_bwd_dq": attention.bwd_dq_launches,
            "flash_bwd_dkv": attention.bwd_dkv_launches,
            "quantize_rowwise": quant.quantize_launches,
            "dequantize_rowwise": quant.dequantize_launches}


def zero_kernel_counts() -> None:
    from learningorchestra_tpu_torch.ops import attention, quant

    attention.launches = attention.bwd_dq_launches = 0
    attention.bwd_dkv_launches = 0
    quant.quantize_launches = quant.quantize_leaves = 0
    quant.dequantize_launches = quant.dequantize_leaves = 0


def rest_job(port, verb, path, body, name):
    """One job through the routes a user calls: the POST (or PATCH), then
    the long poll until it finishes or fails, with the counters at 0
    just before and read just after.  -> (status, metadata, seconds from
    the request to the finished state, launches)."""
    zero_kernel_counts()
    t0 = time.perf_counter()
    status, created = request(port, verb, path, body)
    meta = wait_done(port, name) if status in (200, 201) else created
    return status, meta, time.perf_counter() - t0, kernel_counts()


def wait_done(port, name) -> dict:
    """Long-poll an artifact until it is finished or failed."""
    while True:
        _, polled = request(port, "GET", f"/observe/{name}?timeout=60")
        meta = polled["metadata"]
        if meta.get("finished") or meta.get("jobState") == "failed":
            return meta


def rest_rows(port, path, page=100) -> list:
    """Every document of an artifact through its paginated GET (the
    server caps a page at 100, as the JAX server does)."""
    docs: list = []
    while True:
        _, got = request(port, "GET", f"{path}?skip={len(docs)}"
                                      f"&limit={page}")
        docs += got
        if len(got) < page:
            return docs


def write_token_csv(path) -> tuple:
    """The training phase's 250 rows as the REST phases' CSV."""
    x, y = make_train_data(30522)
    with open(path, "w") as fh:
        fh.write(",".join(REST_FIELDS + ["label"]) + "\n")
        for row, label in zip(x, y):
            fh.write(",".join(map(str, row)) + f",{label}\n")
    return x, y


def run_rest_pipeline(tmp) -> dict:
    """The slice's REST main path on the card: CSV ingest -> projection ->
    model -> train (K1/K2/K3 every step, K4 at the int8 publication) ->
    evaluate and predict (K5 at each load, K1) -> serve, then the failure
    path and a PATCH re-run; every job sequential."""
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.train import checkpoint as ckpt
    from learningorchestra_tpu_torch.train.neural import load_artifact

    csv = f"{tmp}/tokens.csv"
    x, _ = write_token_csv(csv)
    server = APIServer(server_config(f"{tmp}/volumes"), device="cuda")
    port = server.start_background()
    jobs, ok = {}, True

    def run(key, verb, path, body, name, want_state="finished"):
        nonlocal ok
        status, meta, secs, counts = rest_job(port, verb, path, body, name)
        good = status in (200, 201) and meta.get("jobState") == want_state
        jobs[key] = {"status": status, "jobState": meta.get("jobState"),
                     "seconds": secs, "launches": counts, "meta": meta}
        phase(f"rest job {key}", good,
              f"{verb} {path} -> {status}, jobState {meta.get('jobState')}"
              f" in {secs:.2f}s; launches {counts}"
              + ("" if good else f"; metadata {meta}"))
        ok &= good
        return meta

    fit_params = {"x": "$tokens_x", "y": "$tokens.label",
                  "epochs": TRAIN_EPOCHS, "batch_size": TRAIN_SHAPE[0],
                  "quantize_checkpoint": True}
    try:
        meta = run("ingest", "POST", "/dataset/csv",
                   {"datasetName": "tokens", "url": f"file://{csv}"},
                   "tokens")
        dup, _ = request(port, "POST", "/dataset/csv",
                         {"datasetName": "tokens", "url": f"file://{csv}"})
        phase("rest ingest rows", meta.get("rows") == TRAIN_ROWS
              and meta.get("fields") == REST_FIELDS + ["label"]
              and dup == 409,
              f"rows {meta.get('rows')} (want {TRAIN_ROWS}), "
              f"{len(meta.get('fields') or [])} fields, duplicate POST "
              f"-> {dup} (want 409)")
        run("projection", "POST", "/transform/projection",
            {"projectionName": "tokens_x", "datasetName": "tokens",
             "fields": REST_FIELDS}, "tokens_x")
        run("model", "POST", "/model/tensorflow",
            {"modelName": "bert", "class": "BertModel",
             "modulePath": "learningorchestra_tpu.models.text",
             "classParameters": REST_MODEL}, "bert")
        train = run("train", "POST", "/train/tensorflow",
                    {"name": "bert_fit", "parentName": "bert",
                     "method": "fit", "methodParameters": fit_params},
                    "bert_fit")
        _, rows = request(port, "GET", "/train/tensorflow/bert_fit")
        history = [r for r in rows if r.get("docType") == "history"]
        losses = [r.get("loss") for r in history]
        steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // TRAIN_SHAPE[0])
        per_step = REST_LAYERS * steps
        want = {"flash_fwd": per_step, "flash_bwd_dq": per_step,
                "flash_bwd_dkv": per_step, "quantize_rowwise": 1,
                "dequantize_rowwise": 0}
        got = jobs["train"]["launches"]
        phase("rest train", got == want and len(losses) == TRAIN_EPOCHS
              and all(isinstance(v, float) and math.isfinite(v)
                      for v in losses) and losses[0] != losses[-1]
              and train.get("fitTime", 0) > 0,
              f"launches {got} (want {want}: {REST_LAYERS} layers x {steps}"
              " steps, "
              f"one int8 publication); history losses {losses}; fitTime "
              f"{train.get('fitTime')}")
        run("evaluate", "POST", "/evaluate/tensorflow",
            {"name": "bert_eval", "parentName": "bert_fit",
             "method": "evaluate",
             "methodParameters": {"x": "$tokens_x", "y": "$tokens.label"}},
            "bert_eval")
        run("predict", "POST", "/predict/tensorflow",
            {"name": "bert_pred", "parentName": "bert_fit",
             "method": "predict", "methodParameters": {"x": "$tokens_x"}},
            "bert_pred")
        _, ev_rows = request(port, "GET", "/evaluate/tensorflow/bert_eval")
        pr_rows = rest_rows(port, "/predict/tensorflow/bert_pred")
        preds = np.asarray([r["result"] for r in pr_rows if "result" in r],
                           np.float32)
        eval_batches = -(-TRAIN_ROWS // 128)
        ev_l, pr_l = (jobs[k]["launches"] for k in ("evaluate", "predict"))
        phase("rest evaluate/predict launches",
              ev_l["dequantize_rowwise"] == pr_l["dequantize_rowwise"] == 1
              and ev_l["flash_fwd"] == REST_LAYERS * eval_batches
              and pr_l["flash_fwd"] == REST_LAYERS
              and preds.shape == (TRAIN_ROWS, 2)
              and bool(np.isfinite(preds).all()),
              f"evaluate {ev_l} (want K5 1, K1 {REST_LAYERS} x "
              f"{eval_batches} batches), predict {pr_l} (want K5 1, K1 "
              f"{REST_LAYERS} x 1 bucket); "
              f"predictions {preds.shape}; evaluate rows "
              f"{[r for r in ev_rows[1:] if 'loss' in r]}")
        # The same artifact on the CPU (plain dequantize, plain attention).
        artifact = server.ctx.volumes.read_object("train/tensorflow",
                                                  "bert_fit")
        t0 = time.perf_counter()
        ref = load_artifact(artifact, device="cpu").predict(
            x[REST_CPU_ROWS])
        cpu_s = time.perf_counter() - t0
        err = float(np.abs(preds[REST_CPU_ROWS] - ref).max())
        phase("rest predict vs CPU plain path", err <= CPU_ATOL,
              f"rows {REST_CPU_ROWS} (first all-pad): max|dlogit|={err:.3g}"
              f" atol={CPU_ATOL} (CPU {cpu_s:.1f}s)")

        zero_kernel_counts()
        t0 = time.perf_counter()
        status, served = request(port, "POST", "/serve/bert_fit/predict",
                                 {"instances": x[:4].tolist()})
        serve_s = time.perf_counter() - t0
        serve_counts = kernel_counts()
        got = np.asarray(served.get("predictions", []), np.float32)
        serve_err = float(np.abs(got - preds[:4]).max()) \
            if got.shape == (4, 2) else float("inf")
        phase("rest serve", status == 200 and serve_err <= CPU_ATOL
              and serve_counts["dequantize_rowwise"] == 1,
              f"POST /serve/bert_fit/predict -> {status} in {serve_s:.2f}s, "
              f"max|d| vs the predict job {serve_err:.3g}; launches "
              f"{serve_counts}")

        bad = run("failure", "POST", "/train/tensorflow",
                  {"name": "bert_bad", "parentName": "bert", "method": "fit",
                   "methodParameters": {**fit_params,
                                        "x": "$tokens.nosuch"}},
                  "bert_bad", want_state="failed")
        _, bad_rows = request(port, "GET", "/train/tensorflow/bert_bad")
        recorded = [r.get("exception") for r in bad_rows
                    if r.get("docType") == "execution"]
        refused, _ = request(port, "POST", "/train/tensorflow", {
            "name": "bert_ckpt", "parentName": "bert", "method": "fit",
            "methodParameters": {**fit_params, "checkpoint_dir": "/tmp/x"}})
        phase("rest failure path", bool(recorded) and "nosuch" in str(
            recorded[-1]) and refused == 406,
              f"missing column -> jobState {bad.get('jobState')}, execution "
              f"exception {recorded[-1:]}; checkpoint_dir -> {refused} "
              "(want 406)")
        rerun = run("rerun", "PATCH", "/train/tensorflow/bert_fit", {},
                    "bert_fit")
        got = jobs["rerun"]["launches"]
        phase("rest PATCH re-run", got == want
              and rerun.get("fitTime", 0) > 0,
              f"bare PATCH re-ran the fit from the model: launches {got} "
              f"(want {want})")

        # The artifacts' saves and loads, timed apart from the jobs (their
        # launches are not the main path's): the train job's int8 one and
        # the model job's f32 one, which the train job loads.
        vols, timed = server.ctx.volumes, {}
        for kind, quantize in (("train", True), ("model", False)):
            t0 = time.perf_counter()
            est = vols.load_estimator(f"{kind}/tensorflow", "bert_fit"
                                      if kind == "train" else "bert",
                                      device="cuda")
            torch.cuda.synchronize()
            timed[f"{kind}_load_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            vols.save_object(f"{kind}/tensorflow", f"{kind}_resave",
                             est.to_artifact(quantize=quantize))
            timed[f"{kind}_save_s"] = time.perf_counter() - t0
            del est
    finally:
        server.shutdown()

    def job_line(key):
        j = jobs.get(key, {})
        return {"seconds": j.get("seconds"), "launches": j.get("launches")}

    train_s = jobs.get("train", {}).get("seconds")
    fit_s = jobs.get("train", {}).get("meta", {}).get("fitTime")
    launches = {
        "rest_train": {k: jobs[k]["launches"] for k in ("train", "rerun")
                       if k in jobs},
        "rest_evaluate": jobs.get("evaluate", {}).get("launches"),
        "rest_predict": jobs.get("predict", {}).get("launches"),
        "rest_serve": serve_counts,
    }
    return {
        "ok": ok,
        "launches": launches,
        "line": {
            "jobs": {k: job_line(k) for k in (
                "ingest", "projection", "model", "train", "evaluate",
                "predict", "failure", "rerun")},
            "train_e2e_s": train_s, "fit_time_s": fit_s,
            "job_layer_s": train_s - fit_s if train_s and fit_s else None,
            "rerun_fit_time_s": jobs.get("rerun", {}).get("meta", {}).get(
                "fitTime"),
            "artifact_save_s": timed["train_save_s"],
            "artifact_load_s": timed["train_load_s"],
            "model_artifact_save_s": timed["model_save_s"],
            "model_artifact_load_s": timed["model_load_s"],
            "serve_s": serve_s, "predict_cpu_max_abs_err": err,
            "serve_max_abs_err": serve_err,
            # Every REST fit saves its final epoch (async, committed
            # before the job publishes): the train job and its re-run.
            "final_checkpoints": [
                s for s in ckpt.recent_saves
                if s["dir"].endswith("/_checkpoints/bert_fit")],
        },
    }


# -- phase 9: classical estimators and the Titanic pipeline -------------------

# Kaggle Titanic train.csv: 891 rows, 12 columns, 177 blank Age cells.
TITANIC_ROWS, TITANIC_AGE_BLANK = 891, 177
TITANIC_COLUMNS = ["PassengerId", "Survived", "Pclass", "Name", "Sex", "Age",
                   "SibSp", "Parch", "Ticket", "Fare", "Cabin", "Embarked"]
# UCI Covertype: 581,012 rows, 10 quantitative columns (their published
# ranges), 4 wilderness-area and 40 soil-type indicator columns, cover
# types 1-7 at the published class counts.
COVTYPE_CLASS_ROWS = (211840, 283301, 35754, 2747, 9493, 17367, 20510)
COVTYPE_RANGES = ((1859, 3858), (0, 360), (0, 66), (0, 1397), (-173, 601),
                  (0, 7117), (0, 254), (0, 254), (0, 254), (0, 7173))
# Fit rows at the Covertype shape, where the whole table would outgrow
# the phase's time (host tree growth; CPU reference fits of the f32
# solvers; kNN's CPU predict against its training rows; kmeans++ seeding
# on the host).  Every predict on the card runs over all 581,012 rows.
COVTYPE_FIT_ROWS = {"RandomForestClassifier": 25_000,
                    "GradientBoostingClassifier": 2_500,
                    "KNeighborsClassifier": 5_000,
                    "DecisionTreeClassifier": 50_000,
                    "DecisionTreeRegressor": 50_000,
                    "LogisticRegression": 50_000, "SGDClassifier": 50_000,
                    "LinearSVC": 50_000, "SVC": 25_000, "KMeans": 50_000}
# The (shape, estimator) pairs of the CPU reference's second child: the
# Covertype gradient boosting's host tree growth and walks over every
# row (~70 s) run beside the first child's other ~80 s, where one child
# in series set phase 9's critical path.
CPU_REFERENCE_SECOND = {("covtype", "GradientBoostingClassifier")}
TSNE_POINTS = 1000
# Bound on the wait for one estimator's CPU reference (the slowest, the
# Covertype gradient boosting's fit and predict, takes ~50 s alone).
CPU_REFERENCE_TIMEOUT_S = 600
# Card against the CPU: f32 answers within ANSWER_RTOL of their largest
# value; labels equal, but where the CPU's own top-2 margin is within
# MARGIN_RTOL of its score scale (a tie at f32 rounding, ``_tie_margins``:
# reductions run in other orders on the two devices, and among 581,012
# rows a few such ties flip); a solver's coefficients within COEF_RTOL
# of their largest (Adam's normalised steps carry the reduction-order
# differences of a 100,000-row gradient through 200-300 steps: 1.2e-4
# on the unscaled Covertype features, where the CPU tests' 240 rows give
# 2e-6).
# t-SNE: 10 steps at the default rate within 1e-4 of the embedding's
# scale; the full run by its KL divergence at TSNE_RATE, where the
# updates are stable (at the default 200, below ~4,800 points, the
# exaggerated attraction times the rate exceeds 2 and one ulp of input
# moves the final KL by up to 35 %; ROADMAP C).
ANSWER_RTOL, COEF_RTOL, MARGIN_RTOL, KL_RTOL = 1e-4, 1e-3, 1e-5, 1e-2
TSNE_RATE = 20.0
# (module path, class, kwargs ("k": the shape's class count), input,
# answer): the 19 classes.
ESTIMATORS = [
    ("sklearn.preprocessing", "StandardScaler", {}, "x", "transform"),
    ("sklearn.preprocessing", "MinMaxScaler", {}, "x", "transform"),
    ("sklearn.preprocessing", "OneHotEncoder", {}, "cat", "transform"),
    ("sklearn.linear_model", "LinearRegression", {}, "reg", "predict"),
    ("sklearn.linear_model", "Ridge", {}, "reg", "predict"),
    ("sklearn.linear_model", "LogisticRegression", {}, "solver", "predict"),
    ("sklearn.linear_model", "SGDClassifier", {}, "solver", "predict"),
    ("sklearn.naive_bayes", "GaussianNB", {}, "clf", "predict"),
    ("sklearn.naive_bayes", "MultinomialNB", {}, "counts", "predict"),
    ("sklearn.tree", "DecisionTreeClassifier", {}, "clf", "predict"),
    ("sklearn.ensemble", "RandomForestClassifier", {}, "clf", "predict"),
    ("sklearn.ensemble", "GradientBoostingClassifier", {}, "clf", "predict"),
    ("sklearn.tree", "DecisionTreeRegressor", {}, "reg", "predict"),
    ("sklearn.neighbors", "KNeighborsClassifier", {}, "clf", "predict"),
    ("sklearn.svm", "LinearSVC", {}, "solver", "predict"),
    ("sklearn.svm", "SVC", {}, "solver", "predict"),
    ("sklearn.cluster", "KMeans", {"n_clusters": "k"}, "x", "predict"),
    ("sklearn.decomposition", "PCA", {"n_components": 2}, "x", "transform"),
    ("sklearn.manifold", "TSNE", {"learning_rate": TSNE_RATE}, "tsne",
     "fit_transform"),
]


def titanic_table(n: int = TITANIC_ROWS, seed: int = 1912) -> dict:
    """Seeded columns at Kaggle train.csv's schema and marginals: class
    24/21/55 %, 35 % female, 177 of 891 Age blank (None), fares by class,
    mixed text and numeric Tickets, two blank Embarked; survival follows
    sex, class and age."""
    rng = np.random.default_rng(seed)
    pclass = rng.choice([1, 2, 3], n, p=[0.24, 0.21, 0.55])
    female = rng.random(n) < 0.35
    age = np.round(np.clip(rng.normal(29.7, 14.5, n), 0.42, 80.0), 1)
    blank = rng.choice(n, n * TITANIC_AGE_BLANK // TITANIC_ROWS,
                       replace=False)
    fare = np.round(rng.lognormal(np.log([80.0, 20.0, 9.0])[pclass - 1],
                                  0.5), 4)
    logit = 2.5 * female - 0.9 * (pclass - 2) - 0.02 * (age - 30)
    embarked = rng.choice(["S", "C", "Q"], n, p=[0.72, 0.19, 0.09])
    embarked[rng.choice(n, 2, replace=False)] = ""
    ages = [int(a) if a == int(a) else float(a) for a in age]
    for i in blank:
        ages[i] = None
    return {
        "PassengerId": list(range(1, n + 1)),
        "Survived": (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(
            int).tolist(),
        "Pclass": pclass.tolist(),
        "Name": [f"Passenger{i}, Mr. X{i}" for i in range(n)],
        "Sex": np.where(female, "female", "male").tolist(),
        "Age": ages,
        "SibSp": rng.choice([0, 0, 0, 0, 1, 1, 2, 3, 4], n).tolist(),
        "Parch": rng.choice([0, 0, 0, 0, 1, 1, 2], n).tolist(),
        "Ticket": [f"A/5 {rng.integers(1000, 99999)}" if i % 3 == 0
                   else str(rng.integers(10000, 400000)) for i in range(n)],
        "Fare": fare.tolist(),
        "Cabin": [f"C{i}" if i % 5 == 0 else "" for i in range(n)],
        "Embarked": embarked.tolist(),
    }


def write_titanic_csv(path: str, table: dict) -> None:
    import csv

    with open(path, "w", newline="") as fh:
        out = csv.writer(fh)
        out.writerow(TITANIC_COLUMNS)
        for row in zip(*(table[c] for c in TITANIC_COLUMNS)):
            out.writerow(["" if v is None else v for v in row])


# The builder's modeling code: the 7 numeric features of the cast table
# (Age's blanks at the median, Sex and Embarked coded), through what
# pandas DataFrames and the port's Frames share.
TITANIC_MODELING_CODE = """
def prep(df):
    age = df["Age"].to_numpy().astype(float)
    age = np.where(np.isnan(age), np.nanmedian(age), age)
    sex = (df["Sex"].to_numpy() == "female").astype(float)
    emb = df["Embarked"].to_numpy()
    port = np.select([emb == "C", emb == "Q"], [1.0, 2.0], 0.0)
    cols = [df[c].to_numpy().astype(float)
            for c in ("Pclass", "SibSp", "Parch", "Fare")]
    return np.stack(cols + [age, sex, port], axis=1)

features_training = prep(training_df)
features_testing = prep(testing_df)
"""


def titanic_inputs(table: dict) -> dict:
    """The estimator inputs at the Titanic shape: 891 rows of the
    modeling code's 7 features, labels Survived."""
    from learningorchestra_tpu_torch.services.frame import Frame

    frame = Frame([dict(zip(table, row)) for row in zip(*table.values())])
    globs = {"np": np, "training_df": frame, "testing_df": frame}
    exec(TITANIC_MODELING_CODE, globs)  # noqa: S102 — the builder's code
    x = globs["features_training"].astype(np.float32)
    y = np.asarray(table["Survived"])
    cat = np.stack([table["Pclass"], table["Sex"], table["Embarked"]], 1)
    return {"x": x, "y": y, "cat": cat, "k": 2, "shape": "titanic",
            "fit_rows": {}}


def covtype_inputs(seed: int = 54) -> dict:
    """Seeded rows at the Covertype schema: class-dependent quantitative
    columns inside the published ranges (continuous, where the dataset's
    are integers, so that kNN sees no tied distances) and class-dependent
    wilderness and soil indicators."""
    rng = np.random.default_rng(seed)
    y = rng.permutation(np.repeat(np.arange(1, 8), COVTYPE_CLASS_ROWS))
    n = len(y)
    lo, hi = np.asarray(COVTYPE_RANGES, np.float64).T
    centers = rng.uniform(0.2, 0.8, (7, 10))
    quant = lo + np.clip(centers[y - 1] + rng.normal(0, 0.15, (n, 10)),
                         0, 1) * (hi - lo)

    def category(k):
        cum = np.cumsum(rng.dirichlet(np.full(k, 0.5), 7), axis=1)
        return np.minimum((cum[y - 1] < rng.random(n)[:, None]).sum(1),
                          k - 1)

    wild, soil = category(4), category(40)
    x = np.concatenate([quant, np.eye(4)[wild], np.eye(40)[soil]],
                       axis=1).astype(np.float32)
    return {"x": x, "y": y, "cat": np.stack([wild, soil], 1), "k": 7,
            "shape": "covtype", "fit_rows": COVTYPE_FIT_ROWS}


def _decision_scores(est, cls, x_pred):
    """The decision scores of one fitted estimator, or None."""
    if hasattr(est, "decision_function"):
        return est.decision_function(x_pred)
    if cls in ("GaussianNB", "MultinomialNB"):
        return est._joint_log_likelihood(x_pred)
    return None


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def fit_estimator(case, inputs, device) -> dict:
    """Fit one of the 19 on ``device`` and answer over every row: seconds
    of each (the card's synchronised).  The card also gives its decision
    scores; the CPU's are computed only where a comparison needs them
    (a second walk of every tree over every row otherwise)."""
    from learningorchestra_tpu_torch.toolkit import registry

    mod, cls, kwargs, kind, method = case
    kwargs = {k: inputs["k"] if v == "k" else v for k, v in kwargs.items()}
    x, y = inputs["x"], inputs["y"]
    if kind == "cat":
        x = inputs["cat"]
    elif kind == "counts":
        x = x - inputs["x"].min(0)
    elif kind == "tsne":
        x = inputs["tsne_x"]
    rows = inputs["fit_rows"].get(cls, len(x))
    est = registry.resolve(mod, cls)(**kwargs, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    if kind == "tsne":
        answer = est.fit_transform(x)
        sync()
        fit_s, predict_s, scores = time.perf_counter() - t0, 0.0, None
    else:
        target = y.astype(np.float32) if kind == "reg" else y
        est.fit(x[:rows], None if kind in ("x", "cat") else target[:rows])
        sync()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        answer = getattr(est, method)(x)
        scores = None if device == "cpu" else _decision_scores(est, cls, x)
        sync()
        predict_s = time.perf_counter() - t0
    return {"est": est, "x": x, "answer": _host(answer),
            "scores": None if scores is None else _host(scores),
            "fit_s": fit_s, "predict_s": predict_s, "fit_rows": rows,
            "kind": kind}


def _tie_margins(cls, est, x, scores=None, scale=1.0) -> np.ndarray:
    """The CPU estimator's top-2 margin at rows ``x`` over its score
    scale: a label can differ between two devices' f32 roundings only
    where this is within rounding.  kNN: the gap between the k-th and
    (k+1)-th nearest squared distances, KMeans: between the two nearest
    centers, each over the row's largest distance; otherwise the gap
    between the top two scores (decision values, joint log-likelihoods,
    probabilities) over the largest score of the whole predict."""
    if cls in ("KNeighborsClassifier", "KMeans"):
        ref = est._x if cls == "KNeighborsClassifier" else \
            est.cluster_centers_
        q = est._put(x)
        d = np.sort(_host((q * q).sum(1, keepdim=True) - 2.0 * q @ ref.T
                          + (ref * ref).sum(1)[None]), axis=1)
        k = est.n_neighbors if cls == "KNeighborsClassifier" else 1
        return (d[:, k] - d[:, k - 1]) / np.abs(d).max(1)
    if scores is None:
        scores = _host(est.predict_proba(x))
    top = np.sort(scores, axis=1)
    return (top[:, -1] - top[:, -2]) / scale


def compare_estimator(cls, card: dict, cpu: dict, inputs) -> tuple:
    """(ok, detail) of the card's answers against the CPU's."""
    a, b = card["answer"], cpu["answer"]
    cpu_fit = cpu
    if a.shape != b.shape:
        return False, {"shape": [a.shape, b.shape]}
    if cls == "TSNE":
        kl_card = card["est"].kl_divergence_
        kl_cpu = cpu["est"].kl_divergence_
        short = {}
        for side, dev in (("card", "cuda"), ("cpu", "cpu")):
            est = type(card["est"])(n_iter=10, device=dev)
            short[side] = _host(est.fit_transform(inputs["tsne_x"]))
        err10 = float(np.abs(short["card"] - short["cpu"]).max()
                      / np.abs(short["cpu"]).max())
        kl_err = abs(kl_card - kl_cpu) / kl_cpu
        return err10 <= 1e-4 and kl_err <= KL_RTOL and bool(
            np.isfinite(a).all()), {"kl_card": kl_card, "kl_cpu": kl_cpu,
                                    "kl_rel_err": kl_err,
                                    "n_iter10_rel_err": err10}
    detail = {}
    if cls == "KMeans":
        # The fit is held below; the predict is held on the card's own
        # centers (the CPU's sit 1e-5 away, which moves near-ties).
        held = copy.copy(cpu["est"])
        held.cluster_centers_ = card["est"].cluster_centers_.cpu()
        detail["mismatches_vs_cpu_centers"] = int((a != b).sum())
        cpu = {**cpu, "est": held, "answer": held.predict(cpu["x"])}
        b = cpu["answer"]
    if a.dtype.kind == "f":
        err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        if cls == "PCA":  # components are defined up to sign
            sign = np.sign((a * b).sum(0))
            err = float(np.abs(a * sign - b).max() / np.abs(b).max())
        detail["rel_err"] = err
        ok = err <= ANSWER_RTOL
    else:
        # Labels: equal, but where the CPU's own scores tie at rounding.
        bad = np.flatnonzero(a != b)
        scores = None
        if bad.size:
            scores = _decision_scores(cpu["est"], cls, cpu["x"])
            scores = None if scores is None else _host(scores)
        margins = _tie_margins(
            cls, cpu["est"], cpu["x"][bad],
            None if scores is None else scores[bad],
            1.0 if scores is None else float(np.abs(scores).max()),
        ) if bad.size else np.zeros(0)
        detail["mismatches"] = int(bad.size)
        detail["worst_flip_margin"] = float(margins.max(initial=0.0))
        ok = bool((margins <= MARGIN_RTOL).all())
    if card["kind"] == "solver":
        ce, cc = _host(card["est"].coef_), _host(cpu["est"].coef_)
        detail["coef_rel_err"] = float(np.abs(ce - cc).max()
                                       / np.abs(cc).max())
        ok &= detail["coef_rel_err"] <= COEF_RTOL
    if cls == "KMeans":
        fitted = cpu_fit["est"]
        fit_x = cpu["x"][:cpu["fit_rows"]]
        bad = np.flatnonzero(card["est"].labels_ != fitted.labels_)
        margins = _tie_margins(cls, fitted, fit_x[bad]) if bad.size \
            else np.zeros(0)
        ce = _host(card["est"].cluster_centers_)
        cc = _host(fitted.cluster_centers_)
        detail.update(
            fit_label_mismatches=int(bad.size),
            worst_fit_flip_margin=float(margins.max(initial=0.0)),
            centers_rel_err=float(np.abs(ce - cc).max() / np.abs(cc).max()))
        ok &= bool((margins <= MARGIN_RTOL).all())
    return ok, detail


def prepare_zoo_inputs(inputs) -> dict:
    """Add the t-SNE rows (``TSNE_POINTS`` of the shape's, seeded,
    standardised) to a shape's inputs."""
    rng = np.random.default_rng(9)
    pick = rng.choice(len(inputs["x"]), min(TSNE_POINTS, len(inputs["x"])),
                      replace=False)
    xs = inputs["x"][pick]
    inputs["tsne_x"] = (xs - xs.mean(0)) / np.maximum(xs.std(0), 1e-6)
    return inputs


def _inputs_digest(inputs) -> str:
    import hashlib

    digest = hashlib.sha1()
    for key in ("x", "y", "cat", "tsne_x"):
        digest.update(np.ascontiguousarray(inputs[key]).tobytes())
    return digest.hexdigest()


def fit_card_side(inputs) -> dict:
    """Every classical estimator fitted and answering on the card at one
    shape: {class: fit_estimator's result, or the exception it raised}."""
    out = {}
    for case in ESTIMATORS:
        try:
            out[case[1]] = fit_estimator(case, inputs, "cuda")
        except Exception as exc:  # noqa: BLE001 — fails that estimator
            out[case[1]] = exc
    return out


def zoo_shapes() -> list:
    """Phase 9's two shapes, built the same way in the script and in its
    CPU-reference child."""
    return [prepare_zoo_inputs(titanic_inputs(titanic_table())),
            prepare_zoo_inputs(covtype_inputs())]


def _reference_part(shape: str, cls: str) -> int:
    """Which CPU-reference child answers ``cls`` at ``shape``."""
    return int((shape, cls) in CPU_REFERENCE_SECOND)


def cpu_reference_child(outdir: str, part: int) -> int:
    """Phase 9's CPU reference (``chip_smoke.py --cpu-reference DIR
    PART``): at each shape, every estimator of this part
    (``_reference_part``) fitted and answering on the CPU, written to
    ``DIR/<shape>_<class>.pkl`` as it finishes (the error's repr where it
    raised), after ``DIR/<shape>.<part>.digest`` of the inputs it used.
    It runs beside the card's side of phase 9, so the host-bound
    reference overlaps the card's work; it never touches the card."""
    import pickle

    def dump(name, obj):
        with open(f"{outdir}/{name}.tmp", "wb") as f:
            pickle.dump(obj, f)
        os.replace(f"{outdir}/{name}.tmp", f"{outdir}/{name}.pkl")

    for inputs in zoo_shapes():
        shape = inputs["shape"]
        cases = [case for case in ESTIMATORS
                 if _reference_part(shape, case[1]) == part]
        if not cases:
            continue
        dump(f"{shape}.{part}.digest", _inputs_digest(inputs))
        for case in cases:
            try:
                res = fit_estimator(case, inputs, "cpu")
                res.pop("x")
            except Exception as exc:  # noqa: BLE001 — the parent fails
                # that estimator with it.
                res = {"error": repr(exc)}
            dump(f"{shape}_{case[1]}", res)
    return 0


class CpuReference:
    """The two CPU-reference children of phase 9, started at once; ``get``
    waits (bounded) for one estimator's result and checks that its child
    built the same inputs; ``stop`` ends the children."""

    def __init__(self, outdir: str):
        import pickle

        self._pickle = pickle
        self.dir = outdir
        os.makedirs(outdir, exist_ok=True)
        # Each child keeps this process's thread counts: a CPU fit's
        # reductions, and so a 50,000-row KMeans fit's labels, depend on
        # them.
        self.children = []
        for part in (0, 1):
            with open(f"{outdir}/child{part}.log", "w") as log:
                self.children.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--cpu-reference", outdir, str(part)],
                    stdout=log, stderr=subprocess.STDOUT))
        self._checked = set()

    def _load(self, name: str, part: int):
        path = f"{self.dir}/{name}.pkl"
        _poll(lambda: os.path.exists(path), CPU_REFERENCE_TIMEOUT_S,
              f"CPU reference {name}", self.children[part])
        with open(path, "rb") as f:
            return self._pickle.load(f)

    def get(self, inputs, cls: str) -> dict:
        shape = inputs["shape"]
        part = _reference_part(shape, cls)
        if (shape, part) not in self._checked:
            if (self._load(f"{shape}.{part}.digest", part)
                    != _inputs_digest(inputs)):
                raise RuntimeError(f"the CPU reference built other "
                                   f"{shape} inputs than the card's")
            self._checked.add((shape, part))
        res = self._load(f"{shape}_{cls}", part)
        if "error" in res:
            raise RuntimeError(f"CPU reference: {res['error']}")
        return res

    def stop(self) -> None:
        for child in self.children:
            if child.poll() is None:
                child.kill()
            child.wait()


def run_estimator_zoo(inputs, cards: dict, reference: CpuReference) -> list:
    """Every classical estimator's answers on the card (``cards``) held
    against the CPU reference's at one shape."""
    lines = []
    for case in ESTIMATORS:
        cls = case[1]
        try:
            card = cards[cls]
            if isinstance(card, Exception):
                raise card
            cpu = {**reference.get(inputs, cls), "x": card["x"]}
            ok, detail = compare_estimator(cls, card, cpu, inputs)
        except Exception as exc:  # noqa: BLE001 — the failed estimator
            # fails the phase; the others still run.
            phase(f"estimator {inputs['shape']} {cls}", False, repr(exc))
            continue
        rows = len(inputs["tsne_x"] if cls == "TSNE" else inputs["x"])
        line = {"estimator": cls, "shape": inputs["shape"],
                "fit_rows": card["fit_rows"] if cls != "TSNE" else rows,
                "predict_rows": rows if cls != "TSNE" else 0,
                "fit_s": card["fit_s"], "predict_s": card["predict_s"],
                "cpu_fit_s": cpu["fit_s"], "cpu_predict_s": cpu["predict_s"],
                **detail}
        phase(f"estimator {inputs['shape']} {cls}", ok,
              json.dumps(line, default=float))
        lines.append(line)
    return lines


TITANIC_FEATURES = ["Pclass", "SibSp", "Parch", "Fare"]
BUILDER_CLASSIFIERS = ["LogisticRegression", "DecisionTree", "RandomForest",
                       "GradientBoosting", "NaiveBayes"]
# Phase 8's fine-tune recipe (BERT-base, T=128, batch 32, 2 epochs) as a
# grid over the learning rate.
TUNE_RATES = [2e-5, 3e-5]


def run_titanic_rest(tmp) -> dict:
    """Phase 9 (b): the Titanic pipeline over REST on the card, every job
    timed from its request to ``finished`` with its kernel launches."""
    import pickle

    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.toolkit.base import map_tensors
    from learningorchestra_tpu_torch.train import checkpoint as ckpt

    table = titanic_table()
    write_titanic_csv(f"{tmp}/titanic.csv", table)
    write_token_csv(f"{tmp}/tokens.csv")
    server = APIServer(server_config(f"{tmp}/volumes"), device="cuda")
    port = server.start_background()
    jobs, ok = {}, True

    def run(key, verb, path, body, name, want_state="finished"):
        nonlocal ok
        status, meta, secs, counts = rest_job(port, verb, path, body, name)
        good = status in (200, 201) and meta.get("jobState") == want_state
        jobs[key] = {"seconds": secs, "launches": counts, "meta": meta}
        phase(f"titanic job {key}", good,
              f"{verb} {path} -> {status}, jobState {meta.get('jobState')}"
              f" in {secs:.2f}s" + ("" if good else f"; metadata {meta}"))
        ok &= good
        return meta

    fit = {"x": "$titanic_scaled", "y": "$titanic.Survived"}
    train, tune, bert, builder, got = {}, {}, {}, {}, {}
    score, trials, bert_trials, builder_s = [], [], [], None
    rf = {"modulePath": "sklearn.ensemble", "class": "RandomForestClassifier",
          "classParameters": {}}
    try:
        run("ingest", "POST", "/dataset/csv",
            {"datasetName": "titanic", "url": f"file://{tmp}/titanic.csv"},
            "titanic")
        _, before = request(port, "GET", "/dataset/csv/titanic?limit=100")
        run("datatype", "PATCH", "/transform/dataType",
            {"datasetName": "titanic",
             "types": {"Age": "number", "Fare": "number",
                       "Ticket": "string"}}, "titanic")
        _, after = request(port, "GET", "/dataset/csv/titanic?limit=100")
        rows = [(a, b) for a, b in zip(before[1:], after[1:])]
        cast_ok = len(rows) == 99 and all(
            b["Age"] == (None if a["Age"] is None else float(a["Age"]))
            and isinstance(b["Ticket"], str) for a, b in rows) and any(
            a["Age"] is None for a, _ in rows)
        phase("titanic dataType cast", cast_ok,
              "Age/Fare to numbers (blank Age stays None), Ticket to "
              f"strings, over the first {len(rows)} rows")
        ok &= cast_ok
        run("projection", "POST", "/transform/projection",
            {"projectionName": "titanic_x", "datasetName": "titanic",
             "fields": TITANIC_FEATURES}, "titanic_x")
        run("transform", "POST", "/transform/scikitlearn",
            {"name": "titanic_scaled", "modulePath": "sklearn.preprocessing",
             "class": "StandardScaler", "method": "fit_transform",
             "methodParameters": {"x": "$titanic_x"}}, "titanic_scaled")
        run("model", "POST", "/model/scikitlearn", {"name": "rf", **rf},
            "rf")
        train = run("train", "POST", "/train/scikitlearn",
                    {"name": "rf_fit", "parentName": "rf", "method": "fit",
                     "methodParameters": fit}, "rf_fit")
        with open(server.ctx.volumes.path_for("train/scikitlearn", "rf_fit"),
                  "rb") as fh:
            raw = pickle.load(fh)
        devices = set()
        map_tensors(vars(raw), lambda t: devices.add(t.device.type))
        phase("titanic artifact on the CPU", devices == {"cpu"},
              f"the card-fitted forest's pickle holds tensors on {devices}")
        ok &= devices == {"cpu"}
        ev = run("evaluate", "POST", "/evaluate/scikitlearn",
                 {"name": "rf_eval", "parentName": "rf_fit",
                  "method": "score", "methodParameters": fit}, "rf_eval")
        run("predict", "POST", "/predict/scikitlearn",
            {"name": "rf_pred", "parentName": "rf_fit", "method": "predict",
             "methodParameters": {"x": "$titanic_scaled"}}, "rf_pred")
        preds = [r["result"] for r in rest_rows(
            port, "/predict/scikitlearn/rf_pred") if "result" in r]
        _, ev_rows = request(port, "GET", "/evaluate/scikitlearn/rf_eval")
        score = [r["result"] for r in ev_rows if "result" in r]
        good = len(preds) == TITANIC_ROWS and set(preds) <= {0, 1} and \
            bool(score) and 0.6 < score[0] <= 1.0
        phase("titanic config 1", good,
              f"{len(preds)} predictions, training-set accuracy {score}")
        ok &= good

        zero_kernel_counts()
        t0 = time.perf_counter()
        status, created = request(port, "POST", "/builder/sparkml", {
            "trainDatasetName": "titanic", "testDatasetName": "titanic",
            "classifiersList": BUILDER_CLASSIFIERS, "labelField": "Survived",
            "modelingCode": TITANIC_MODELING_CODE})
        builder = {}
        for clf in BUILDER_CLASSIFIERS:
            meta = wait_done(port, f"titanic{clf}")
            builder[clf] = {"accuracy": meta.get("accuracy"),
                            "F1": meta.get("F1"),
                            "fitTime": meta.get("fitTime"),
                            "jobState": meta.get("jobState")}
        builder_s = time.perf_counter() - t0
        good = status == 201 and all(
            b["jobState"] == "finished" and 0.5 < b["accuracy"] <= 1.0
            for b in builder.values())
        phase("titanic builder", good,
              f"POST /builder/sparkml -> {status}, five classifiers at once "
              f"in {builder_s:.2f}s: {json.dumps(builder)}")
        ok &= good

        tune = run("rf_tune", "POST", "/tune/scikitlearn",
                   {"name": "rf_tune", "parentName": "rf", "method": "fit",
                    "paramGrid": {"n_estimators": [25, 50],
                                  "max_depth": [4, 8]},
                    "methodParameters": fit}, "rf_tune")
        trials = [r for r in rest_rows(port, "/tune/scikitlearn/rf_tune")
                  if "score" in r]
        good = len(trials) == 4 and tune.get("bestParams") is not None
        phase("titanic RF tune", good,
              f"{len(trials)} trials, bestParams {tune.get('bestParams')}, "
              f"bestScore {tune.get('bestScore')}")
        ok &= good

        run("tokens", "POST", "/dataset/csv",
            {"datasetName": "tokens", "url": f"file://{tmp}/tokens.csv"},
            "tokens")
        run("tokens_x", "POST", "/transform/projection",
            {"projectionName": "tokens_x", "datasetName": "tokens",
             "fields": REST_FIELDS}, "tokens_x")
        run("bert", "POST", "/model/tensorflow",
            {"modelName": "bert", "class": "BertModel",
             "modulePath": "learningorchestra_tpu.models.text",
             "classParameters": REST_MODEL}, "bert")
        bert = run("bert_tune", "POST", "/tune/tensorflow", {
            "name": "bert_tune", "parentName": "bert", "method": "fit",
            "paramGrid": {"learning_rate": TUNE_RATES,
                          **{k: [v] for k, v in REST_MODEL.items()
                             if k != "learning_rate"}},
            "methodParameters": {"x": "$tokens_x", "y": "$tokens.label",
                                 "epochs": TRAIN_EPOCHS,
                                 "batch_size": TRAIN_SHAPE[0],
                                 "quantize_checkpoint": True}},
            "bert_tune")
        bert_trials = [r for r in rest_rows(port, "/tune/tensorflow/"
                                            "bert_tune") if "score" in r]
        steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // TRAIN_SHAPE[0])
        score_batches = -(-TRAIN_ROWS // 128)
        per_trial = {"flash_fwd": REST_LAYERS * (steps + score_batches),
                     "flash_bwd_dq": REST_LAYERS * steps,
                     "flash_bwd_dkv": REST_LAYERS * steps}
        want = {k: v * len(TUNE_RATES) for k, v in per_trial.items()}
        want.update(quantize_rowwise=1, dequantize_rowwise=0)
        got = jobs["bert_tune"]["launches"]
        good = got == want and len(bert_trials) == len(TUNE_RATES) and \
            bert.get("bestParams", {}).get("learning_rate") in TUNE_RATES
        phase("titanic BERT tune", good,
              f"{len(bert_trials)} trials {[(t['params']['learning_rate'], t['score'], t['fitTime']) for t in bert_trials]}, "
              f"bestParams {bert.get('bestParams')}; launches {got} (want "
              f"{want}: per trial {per_trial}, K4 once at the int8 "
              "publication of the best)")
        ok &= good
    finally:
        server.shutdown()
    return {
        "ok": ok,
        "launches": jobs.get("bert_tune", {}).get("launches", {}),
        "line": {
            "jobs": {k: j["seconds"] for k, j in jobs.items()},
            "train_fit_time_s": train.get("fitTime"),
            "evaluate_score": score,
            "builder_s": builder_s, "builder": builder,
            "rf_tune": {"bestParams": tune.get("bestParams"),
                        "bestScore": tune.get("bestScore"),
                        "trials": [{"params": t["params"],
                                    "score": t["score"],
                                    "fitTime": t["fitTime"]}
                                   for t in trials]},
            "bert_tune": {"bestParams": bert.get("bestParams"),
                          "bestScore": bert.get("bestScore"),
                          "trials": [{"learning_rate":
                                      t["params"]["learning_rate"],
                                      "score": t["score"],
                                      "fitTime": t["fitTime"]}
                                     for t in bert_trials],
                          "launches_per_trial": {
                              k: v / len(TUNE_RATES) for k, v in got.items()
                              if k.startswith("flash")},
                          # Each trial saves its final epoch under the
                          # tune's managed tree.
                          "trial_checkpoints": [
                              s for s in ckpt.recent_saves
                              if "/_checkpoints/bert_tune/" in s["dir"]]},
        },
    }


# -- phase 10: the crash drill (journal, boot recovery, checkpoint resume) ----

CRASH_JOB, CRASH_EPOCHS = "bert_crash", 4
# Before each epoch from the third on, the child waits this long: a
# BERT-base epoch of 8 steps takes well under a second, so without it
# the fit could finish before the SIGKILL lands.
CRASH_DELAY_S = 3.0
CRASH_BAR = 3e-2  # the bf16 bar: recovered vs uninterrupted parameters


class WebhookReceiver:
    """A local endpoint for the drill's wildcard webhook, recording every
    POSTed body."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        import threading

        got = self.got = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                got.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/hook"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def crash_child(tmp: str) -> int:
    """Phase 10's first process (``chip_smoke.py --crash-drill-child
    <tmp>``): the port's APIServer on the card over ``<tmp>``'s store,
    its port written to ``<tmp>/child.port``; epochs from the third on
    wait ``CRASH_DELAY_S`` first.  Runs until the parent's SIGKILL (or
    exits once its parent is gone)."""
    import os

    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.train.neural import NeuralEstimator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The cost plane reports MFU against the card's dense bf16 peak (read
    # at its first use, so before any phase runs).
    os.environ["LO_TPU_COSTS_PEAK_FLOPS"] = repr(COSTS_PEAK_FLOPS)
    epoch_raw = NeuralEstimator._device_epoch

    def slowed(self, *args):
        if args[-1] >= 2:  # the epoch index
            time.sleep(CRASH_DELAY_S)
        return epoch_raw(self, *args)

    NeuralEstimator._device_epoch = slowed
    parent = os.getppid()
    server = APIServer(server_config(f"{tmp}/volumes"), device="cuda")
    port = server.start_background()
    with open(f"{tmp}/child.port.tmp", "w") as fh:
        fh.write(str(port))
    os.replace(f"{tmp}/child.port.tmp", f"{tmp}/child.port")
    while os.getppid() == parent:
        time.sleep(0.5)
    return 1


def _poll(cond, timeout_s: float, what: str, child=None):
    """Wait for ``cond()`` to return a truthy value, bounded; a child
    that died first ends the wait."""
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        got = cond()
        if got:
            return got
        if child is not None and child.poll() is not None:
            raise RuntimeError(f"{what}: the child exited with "
                               f"{child.returncode}")
        time.sleep(0.05)
    raise RuntimeError(f"{what}: not within {timeout_s:.0f}s")


def _read_json(path):
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def run_crash_drill(tmp) -> dict:
    """Phase 10: a BERT-base REST fine-tune SIGKILLed mid-fit in a child
    process, recovered by a second boot in this process from its newest
    checkpoint (K1/K2/K3 only for the epochs after it, K4 at the int8
    publication), its webhook's ``finished`` event received, an evaluate
    of the recovered artifact (K5), and the same job run uninterrupted to
    compare parameters."""
    import os

    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.jobs.journal import JOURNAL_COLLECTION
    from learningorchestra_tpu_torch.train import checkpoint as ckpt

    write_token_csv(f"{tmp}/tokens.csv")
    vols = f"{tmp}/volumes"
    fit_params = {"x": "$tokens_x", "y": "$tokens.label",
                  "epochs": CRASH_EPOCHS, "batch_size": TRAIN_SHAPE[0],
                  "checkpoint_every": 1, "checkpoint_min_interval_s": 0,
                  "quantize_checkpoint": True}
    steps_per_epoch = -(-TRAIN_ROWS // TRAIN_SHAPE[0])
    receiver = WebhookReceiver()
    ok, line = True, {"delay_s": CRASH_DELAY_S, "epochs": CRASH_EPOCHS}
    with open(f"{tmp}/child.log", "w") as log:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--crash-drill-child", tmp],
            stdout=log, stderr=subprocess.STDOUT)
    try:
        port = int(_poll(lambda: _read_json(f"{tmp}/child.port"), 300,
                         "child server", child))
        status, hook = request(port, "POST", "/observe/webhook",
                               {"url": receiver.url})
        steps = [
            ("/dataset/csv", {"datasetName": "tokens",
                              "url": f"file://{tmp}/tokens.csv"}, "tokens"),
            ("/transform/projection", {"projectionName": "tokens_x",
                                       "datasetName": "tokens",
                                       "fields": REST_FIELDS}, "tokens_x"),
            ("/model/tensorflow", {"modelName": "bert", "class": "BertModel",
                                   "modulePath":
                                   "learningorchestra_tpu.models.text",
                                   "classParameters": REST_MODEL}, "bert"),
        ]
        for path, body, name in steps:
            request(port, "POST", path, body)
            wait_done(port, name)
        t0 = time.perf_counter()
        status_train, _ = request(port, "POST", "/train/tensorflow", {
            "name": CRASH_JOB, "parentName": "bert", "method": "fit",
            "methodParameters": fit_params})
        marker = f"{vols}/_checkpoints/{CRASH_JOB}/latest.json"
        _poll(lambda: (_read_json(marker) or {}).get("step", 0) >= 2, 600,
              "checkpoint step 2", child)
        child.kill()
        child.wait(timeout=60)
        line["child_train_s_to_kill"] = time.perf_counter() - t0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
    killed_at = _read_json(marker)["step"]
    phase("crash drill kill", status == 201 and status_train == 201
          and child.returncode == -9 and killed_at >= 2,
          f"wildcard webhook -> {status}, train POST -> {status_train}; "
          f"SIGKILL at committed step {killed_at} of {CRASH_EPOCHS} "
          f"(child exit {child.returncode}, epochs from the third delayed "
          f"{CRASH_DELAY_S}s)")
    line["killed_at_step"] = killed_at

    # The second boot: journal replay, recovery, the resumed fit.
    resume_s = []
    resume_raw = ckpt.resume_or_none

    def timed_resume(*args, **kwargs):
        t = time.perf_counter()
        try:
            return resume_raw(*args, **kwargs)
        finally:
            resume_s.append(time.perf_counter() - t)

    ckpt.resume_or_none = timed_resume
    zero_kernel_counts()
    t_boot, t0 = time.time(), time.perf_counter()
    server = None
    try:
        server = APIServer(server_config(vols), device="cuda")
        line["boot_s"] = time.perf_counter() - t0
        port2 = server.start_background()
        meta = wait_done(port2, CRASH_JOB)
        line["recovered_to_finished_s"] = time.perf_counter() - t0
        counts = kernel_counts()
        ckpt.resume_or_none = resume_raw
        t1 = time.perf_counter()
        server.ctx.journal.replay()
        line["journal_replay_s"] = time.perf_counter() - t1
        life = [d for d in server.ctx.documents.find(JOURNAL_COLLECTION)
                if d["job"] == CRASH_JOB and d["epoch"] == 2]
        at = {d["event"]: d["at"] for d in life}
        line["boot_to_redispatch_s"] = at.get("queued", t_boot) - t_boot
        line["boot_to_running_s"] = at.get("running", t_boot) - t_boot
        line["resume_load_s"] = resume_s
        _, rows = request(port2, "GET", f"/train/tensorflow/{CRASH_JOB}")
        history = [r for r in rows if r.get("docType") == "history"]
        per = REST_LAYERS * steps_per_epoch * (CRASH_EPOCHS - killed_at)
        want = {"flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per,
                "quantize_rowwise": 1, "dequantize_rowwise": 0}
        good = (meta.get("jobState") == "finished"
                and meta.get("engineEpoch") == 2
                and len(history) == CRASH_EPOCHS and counts == want
                and [e["event"] for e in life][:3] == [
                    "submitted", "queued", "running"])
        phase("crash drill recovery", good,
              f"jobState {meta.get('jobState')}, engineEpoch "
              f"{meta.get('engineEpoch')} (want 2), {len(history)} history "
              f"epochs (want {CRASH_EPOCHS}); launches {counts} (want "
              f"{want}: {REST_LAYERS} layers x {steps_per_epoch} steps x "
              f"{CRASH_EPOCHS - killed_at} epochs after step {killed_at}, "
              f"one int8 publication); journal epoch 2: "
              f"{[e['event'] for e in life]}; boot {line['boot_s']:.2f}s, "
              f"to finished {line['recovered_to_finished_s']:.2f}s")
        ok &= good
        hooked = _poll(lambda: [b for b in receiver.got
                                if b["name"] == CRASH_JOB], 60,
                       "webhook delivery")
        good = (hooked[0]["event"] == "finished"
                and hooked[0]["metadata"].get("engineEpoch") == 2)
        phase("crash drill webhook", good,
              f"received {[(b['name'], b['event']) for b in receiver.got]}")
        ok &= good
        status, ev, ev_s, ev_counts = rest_job(
            port2, "POST", "/evaluate/tensorflow",
            {"name": "crash_eval", "parentName": CRASH_JOB,
             "method": "evaluate",
             "methodParameters": {"x": "$tokens_x", "y": "$tokens.label"}},
            "crash_eval")
        eval_batches = -(-TRAIN_ROWS // 128)
        good = (ev.get("jobState") == "finished"
                and ev_counts["dequantize_rowwise"] == 1
                and ev_counts["flash_fwd"] == REST_LAYERS * eval_batches)
        phase("crash drill evaluate", good,
              f"evaluate of the recovered artifact -> {status}, "
              f"{ev.get('jobState')} in {ev_s:.2f}s; launches {ev_counts} "
              f"(want K5 1, K1 {REST_LAYERS} x {eval_batches})")
        ok &= good
        status, whole, whole_s, whole_counts = rest_job(
            port2, "POST", "/train/tensorflow",
            {"name": "bert_whole", "parentName": "bert", "method": "fit",
             "methodParameters": fit_params}, "bert_whole")
        per = REST_LAYERS * steps_per_epoch * CRASH_EPOCHS
        good = whole.get("jobState") == "finished" and whole_counts == {
            "flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per,
            "quantize_rowwise": 1, "dequantize_rowwise": 0}
        phase("crash drill uninterrupted run", good,
              f"the same job from epoch 0 -> {whole.get('jobState')} in "
              f"{whole_s:.2f}s; launches {whole_counts}")
        ok &= good
        # The final f32 states, recovered against uninterrupted.
        states = [torch.load(f"{vols}/_checkpoints/{job}/step_"
                             f"{CRASH_EPOCHS}/{ckpt.STATE_FILE}",
                             map_location="cpu", weights_only=True)
                  for job in (CRASH_JOB, "bert_whole")]
        pairs = list(zip(_flat(states[0]["params"]),
                         _flat(states[1]["params"])))
        diff = max(float((a - b).abs().max()) for (_, a), (_, b) in pairs)
        _, whole_rows = request(port2, "GET", "/train/tensorflow/bert_whole")
        losses = [[r["loss"] for r in got if r.get("docType") == "history"]
                  for got in (rows, whole_rows)]
        loss_diff = max(abs(a - b) for a, b in zip(*losses))
        good = (len(pairs) > 0 and diff <= CRASH_BAR
                and len(losses[1]) == CRASH_EPOCHS and loss_diff <= CRASH_BAR)
        phase("crash drill parameters", good,
              f"max|recovered - uninterrupted| over {len(pairs)} leaves = "
              f"{diff:.3g}, history losses {loss_diff:.3g} (expected 0: "
              f"K1-K3 are bitwise equal run to run; bar {CRASH_BAR})")
        ok &= good
        line.update(
            launches={"recovered_train": counts, "evaluate": ev_counts,
                      "uninterrupted_train": whole_counts},
            evaluate_s=ev_s, uninterrupted_s=whole_s,
            uninterrupted_fit_time_s=whole.get("fitTime"),
            recovered_fit_time_s=meta.get("fitTime"),
            param_max_abs_diff=diff, loss_max_abs_diff=loss_diff,
            checkpoints=[s for s in ckpt.recent_saves
                         if "/_checkpoints/bert_" in s["dir"]])
    finally:
        ckpt.resume_or_none = resume_raw
        receiver.close()
        if server is not None:
            server.shutdown()
    return {"ok": ok, "line": line}


# -- phase 11: the text pipeline and beyond-RAM datasets over REST -----------

# The Large Movie Review Dataset's split (Maas et al., 2011), as a shape:
# 25,000 train and 25,000 test reviews, balanced; the text is seeded.  Cut
# to this many per split (1 full 4,096-row shard and a tail of 8: two
# shard lengths, so two streaming programs) to bound the run's time; the
# row shape, vocabulary and lengths stay.
IMDB_ROWS = 4_104
IMDB_TYPES = 20_000  # synthetic word types, Zipf-distributed
IMDB_SENTIMENT = 200  # sentiment-bearing types per polarity
IMDB_SENTIMENT_SHARE = 0.03  # of a review's words
TEXT_VOCAB, TEXT_LEN, TEXT_SHARD = 8000, 128, 4096
CONFIG3_LEN = 80  # BASELINE config 3's Keras IMDb sequence length
STREAM_BATCH = 32
MNIST_ROWS, MNIST_BATCH = 60_000, 1024
# Covertype's schema (54 features + Cover_Type), cut from 581,012 rows:
# the sharded CSV ingest parses in Python (the native parser is A.11).
COVTYPE_STREAM_ROWS, COVTYPE_STREAM_SHARD = 100_000, 16_384
TSNE_PLOT_ROWS = 2000
# Streaming against in-memory at BERT-base: 2 shards of this many rows.
STREAM_CHECK_SHARD, STREAM_CHECK_BAR = 256, 3e-2
TEXT_CPU_ROWS = [0, 1, 2, 3, 4, 5, 6, 7]

TSNE_DATA_FUNCTION = """
shard = data.load_shard(0)
response = (shard["tokens"][:rows].astype("float32"), shard["label"][:rows])
print("rows", len(response[1]))
"""


def imdb_vocabulary(seed: int = 2011):
    """(word types in Zipf rank order, positive types, negative types,
    Zipf probabilities): pronounceable seeded strings."""
    rng = np.random.default_rng(seed)
    syllables = np.asarray([c + v for c in "bcdfghjklmnprstvwz"
                            for v in "aeiou"])
    want = IMDB_TYPES + 2 * IMDB_SENTIMENT
    types: dict = {}
    while len(types) < want:
        for k in rng.integers(1, 5, want):
            types.setdefault("".join(rng.choice(syllables, k)), None)
    words = np.asarray(list(types)[:want])
    p = 1.0 / np.arange(1, IMDB_TYPES + 1) ** 1.07
    return (words[:IMDB_TYPES], words[IMDB_TYPES:IMDB_TYPES + IMDB_SENTIMENT],
            words[IMDB_TYPES + IMDB_SENTIMENT:], p / p.sum())


def write_reviews(path, seed: int, vocab) -> np.ndarray:
    """IMDB_ROWS seeded reviews (long-tailed lengths around 180 words, a
    share of sentiment-bearing words) as a review,sentiment CSV; returns
    the labels (1 = pos)."""
    import csv

    words, pos, neg, p = vocab
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(np.log(180), 0.6, IMDB_ROWS), 10,
                      1500).astype(int)
    labels = rng.permutation(np.arange(IMDB_ROWS) % 2)
    total = int(lengths.sum())
    table = np.concatenate([words, pos, neg])
    ids = rng.choice(IMDB_TYPES, total, p=p)
    senti = rng.random(total) < IMDB_SENTIMENT_SHARE
    polarity = np.repeat(labels, lengths)
    ids = np.where(senti, IMDB_TYPES + (1 - polarity) * IMDB_SENTIMENT
                   + rng.integers(0, IMDB_SENTIMENT, total), ids)
    tokens = table[ids]
    ends = np.cumsum(lengths)
    with open(path, "w", newline="") as fh:
        out = csv.writer(fh)
        out.writerow(["review", "sentiment"])
        for i in range(IMDB_ROWS):
            text = " ".join(tokens[ends[i] - lengths[i]:ends[i]])
            out.writerow([text.capitalize() + ".",
                          "pos" if labels[i] else "neg"])
    return labels


def request_raw(port, path) -> tuple:
    """(status, body bytes) of a GET."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", "/api/learningOrchestra/v1" + path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def png_size(data: bytes) -> tuple | None:
    """(width, height) of a PNG whose chunk CRCs hold and whose rows
    decompress to the size its header states, else None."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != \
                zlib.crc32(kind + body):
            return None
        if kind == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    if size is None or len(zlib.decompress(idat)) != size[1] * (
            1 + 3 * size[0]):
        return None
    return size


class FitProbe:
    """Wraps ``NeuralEstimator.fit`` while the phase runs: for each fit,
    its class, its streaming stats (the shard waits), its history and
    how many parameter leaves it moved (copies taken at its first device
    epoch, when a module sized by its input has been built)."""

    def __init__(self):
        from learningorchestra_tpu_torch.train import neural

        cls = neural.NeuralEstimator
        self.cls, self.real = cls, (cls.fit, cls._device_epoch)
        self.fits: list = []
        real_fit, real_epoch = self.real
        probe = self

        def fit(est, *args, **kwargs):
            est.probe_before = None
            out = real_fit(est, *args, **kwargs)
            before = est.probe_before or []
            probe.fits.append({
                "class": type(est).__name__,
                "stream_stats": est.stream_stats,
                "moved": sum(not torch.equal(p.detach(), b) for p, b in zip(
                    est.module.parameters(), before)),
                "leaves": len(before),
                "history": {k: list(v) for k, v in est.history.items()}})
            est.probe_before = None
            return out

        def device_epoch(est, *args, **kwargs):
            if getattr(est, "probe_before", 0) is None:
                est.probe_before = [p.detach().clone()
                                    for p in est.module.parameters()]
            return real_epoch(est, *args, **kwargs)

        cls.fit, cls._device_epoch = fit, device_epoch

    def close(self):
        self.cls.fit, self.cls._device_epoch = self.real


class BpeProbe:
    """Times the tokenizer's training and encoding inside the text jobs."""

    def __init__(self):
        from learningorchestra_tpu_torch.text import bpe

        self.bpe = bpe
        self.train, self.encode = bpe.BpeTokenizer.train, \
            bpe.BpeTokenizer.encode_batch
        self.train_s: list = []
        self.encode_s, self.encode_rows = 0.0, 0
        probe, train, encode = self, self.train, self.encode

        def timed_train(cls, *args, **kwargs):
            t0 = time.perf_counter()
            out = train.__func__(cls, *args, **kwargs)
            probe.train_s.append(time.perf_counter() - t0)
            return out

        def timed_encode(tok, texts, max_len):
            t0 = time.perf_counter()
            out = encode(tok, texts, max_len)
            probe.encode_s += time.perf_counter() - t0
            probe.encode_rows += len(out)
            return out

        bpe.BpeTokenizer.train = classmethod(timed_train)
        bpe.BpeTokenizer.encode_batch = timed_encode

    def close(self):
        self.bpe.BpeTokenizer.train = self.train
        self.bpe.BpeTokenizer.encode_batch = self.encode


def stream_vs_memory(tokens, labels, tmp) -> dict:
    """BERT-base streaming over 2 shards of STREAM_CHECK_SHARD rows
    (``shuffle=False``) against the in-memory fit of the same rows in
    the same order, from one seed; then one shard's fit profiled."""
    from learningorchestra_tpu_torch.models.text import BertModel
    from learningorchestra_tpu_torch.store.sharded import (
        ShardedDataset,
        ShardedTensorWriter,
    )

    n = 2 * STREAM_CHECK_SHARD
    x, y = tokens[:n], labels[:n]
    for name, rows in (("two", n), ("one", STREAM_CHECK_SHARD)):
        writer = ShardedTensorWriter(f"{tmp}/{name}", {
            "tokens": (TEXT_LEN,), "label": ()},
            rows_per_shard=STREAM_CHECK_SHARD)
        writer.append_rows({"tokens": x[:rows], "label": y[:rows]})
        writer.close()
    two, one = ShardedDataset(f"{tmp}/two"), ShardedDataset(f"{tmp}/one")
    streamed, memory = (BertModel(**REST_MODEL, device="cuda")
                        for _ in range(2))
    streamed.fit(two, two["label"], epochs=1, batch_size=STREAM_BATCH,
                 shuffle=False)
    memory.fit(x, y, epochs=1, batch_size=STREAM_BATCH, shuffle=False)
    err = max(float((a.detach() - b.detach()).abs().max())
              for a, b in zip(streamed.module.parameters(),
                              memory.module.parameters()))
    loss_err = abs(streamed.history["loss"][0] - memory.history["loss"][0])
    phase("streaming vs in-memory", err <= STREAM_CHECK_BAR
          and loss_err <= STREAM_CHECK_BAR,
          f"BERT-base, {n} rows as 2 shards of {STREAM_CHECK_SHARD} vs in "
          f"memory, shuffle=False, batch {STREAM_BATCH}: max|dparam| "
          f"{err:.3g}, |dloss| {loss_err:.3g} (bar {STREAM_CHECK_BAR}, 0 "
          f"expected)")
    try:
        prof = profile_step(streamed, one, one["label"], TRAIN_FAMILIES,
                            batch_size=STREAM_BATCH)
    except Exception as exc:  # noqa: BLE001 — where CUPTI tracing is
        # unavailable the share is reported as not measured.
        prof = {"not_measured": repr(exc)}
    return {"max_abs_param": err, "loss_abs": loss_err,
            "profiled_shard": prof}


def run_text_pipeline(tmp, in_memory_step_ms) -> dict:
    """Phase 11 on the card, every job through the port's REST server with
    the kernels' counters at 0 before its request and read after it."""
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.store.sharded import ShardedDataset
    from learningorchestra_tpu_torch.train.neural import load_artifact

    t0 = time.perf_counter()
    vocab = imdb_vocabulary()
    write_reviews(f"{tmp}/imdb_train.csv", 11, vocab)
    write_reviews(f"{tmp}/imdb_test.csv", 12, vocab)
    rng = np.random.default_rng(60_000)
    np.save(f"{tmp}/mnist_x.npy",
            rng.random((MNIST_ROWS, 28, 28, 1), np.float32))
    np.save(f"{tmp}/mnist_y.npy", rng.integers(0, 10, MNIST_ROWS))
    cov = covtype_inputs()
    header = [f"Elevation_{i}" for i in range(10)] + [
        f"Wilderness_Area{i}" for i in range(4)] + [
        f"Soil_Type{i}" for i in range(40)] + ["Cover_Type"]
    np.savetxt(f"{tmp}/covtype.csv", np.concatenate([
        cov["x"][:COVTYPE_STREAM_ROWS],
        cov["y"][:COVTYPE_STREAM_ROWS, None]], axis=1),
        fmt=["%.4f"] * 10 + ["%d"] * 45, delimiter=",",
        header=",".join(header), comments="")
    del cov
    inputs_s = time.perf_counter() - t0

    server = APIServer(server_config(f"{tmp}/volumes"), device="cuda")
    port = server.start_background()
    fits, bpe = FitProbe(), BpeProbe()
    jobs, ok = {}, True

    def run(key, verb, path, body, name):
        nonlocal ok
        status, meta, secs, counts = rest_job(port, verb, path, body, name)
        good = status in (200, 201) and meta.get("jobState") == "finished"
        jobs[key] = {"seconds": secs, "launches": counts, "meta": meta}
        phase(f"text job {key}", good,
              f"{verb} {path} -> {status}, jobState {meta.get('jobState')} "
              f"in {secs:.2f}s; launches {counts}"
              + ("" if good else f"; metadata {meta}"))
        ok &= good
        return meta

    def fit_of(cls):
        return next((f for f in reversed(fits.fits) if f["class"] == cls),
                    {})

    def text(name, parent, max_len, tokenizer_from=None):
        return run(name, "POST", "/transform/text", {
            "name": name, "datasetName": parent, "textField": "review",
            "labelField": "sentiment", "vocabSize": TEXT_VOCAB,
            "maxLen": max_len, "shardRows": TEXT_SHARD,
            "tokenizerFrom": tokenizer_from}, name)

    def train(key, model, data, batch, **extra):
        return run(key, "POST", "/train/tensorflow", {
            "name": key, "parentName": model, "method": "fit",
            "methodParameters": {"x": f"${data}", "y": f"${data}.label",
                                 "epochs": 1, "batch_size": batch,
                                 **extra}}, key)

    def evaluate(key, parent, data):
        return run(key, "POST", "/evaluate/tensorflow", {
            "name": key, "parentName": parent, "method": "evaluate",
            "methodParameters": {"x": f"${data}", "y": f"${data}.label"}},
            key)

    def model(key, module, cls, params):
        return run(key, "POST", "/model/tensorflow", {
            "modelName": key, "modulePath": f"learningorchestra_tpu.{module}",
            "class": cls, "classParameters": params}, key)

    layers = REST_LAYERS
    shard_steps = [-(-r // STREAM_BATCH) for r in
                   [TEXT_SHARD] * (IMDB_ROWS // TEXT_SHARD)
                   + [IMDB_ROWS % TEXT_SHARD]]
    steps = sum(shard_steps)
    eval_batches = sum(-(-r // 128) for r in [TEXT_SHARD] * (
        IMDB_ROWS // TEXT_SHARD) + [IMDB_ROWS % TEXT_SHARD])
    pred_batches = sum(-(-r // 512) for r in [TEXT_SHARD] * (
        IMDB_ROWS // TEXT_SHARD) + [IMDB_ROWS % TEXT_SHARD])
    images, line = {}, {}
    try:
        # 1. Ingest and the label histogram.
        for key, split in (("imdb", "train"), ("imdb_test", "test")):
            run(key, "POST", "/dataset/csv", {
                "datasetName": key,
                "url": f"file://{tmp}/imdb_{split}.csv"}, key)
        run("histogram", "POST", "/explore/histogram", {
            "histogramName": "imdb_hist", "datasetName": "imdb",
            "fields": ["sentiment"]}, "imdb_hist")
        _, hist = request(port, "GET", "/explore/histogram/imdb_hist")
        counts = [r.get("counts") for r in hist[1:] if "counts" in r]
        phase("text histogram", counts == [{"neg": IMDB_ROWS // 2,
                                            "pos": IMDB_ROWS // 2}]
              or counts == [{"pos": IMDB_ROWS // 2, "neg": IMDB_ROWS // 2}],
              f"sentiment counts {counts}")
        # 2. Tokenize: BPE trained on the train split, re-used on the rest.
        tok = text("tok128", "imdb", TEXT_LEN)
        text("tok128_test", "imdb_test", TEXT_LEN, "tok128")
        text("tok80", "imdb", CONFIG3_LEN, "tok128")
        text("tok80_test", "imdb_test", CONFIG3_LEN, "tok128")
        shards = ShardedDataset(server.ctx.volumes.path_for(
            "transform/text", "tok128")).shard_rows
        phase("text shards", len(shards) == len(shard_steps)
              and shards[-1] == IMDB_ROWS % TEXT_SHARD
              and tok.get("labelClasses") == ["neg", "pos"]
              and tok.get("vocabSize") == TEXT_VOCAB,
              f"tok128: shard rows {shards}, labelClasses "
              f"{tok.get('labelClasses')}, vocabSize {tok.get('vocabSize')}")
        # 3. BERT-base: streaming fit, evaluate, predict on the bare split.
        model("bert", "models.text", "BertModel", REST_MODEL)
        bert = train("bert_stream", "bert", "tok128", STREAM_BATCH,
                     quantize_checkpoint=True)
        per_step = layers * steps
        want = {"flash_fwd": per_step, "flash_bwd_dq": per_step,
                "flash_bwd_dkv": per_step, "quantize_rowwise": 1,
                "dequantize_rowwise": 0}
        got = jobs["bert_stream"]["launches"]
        probe = fit_of("BertModel")
        hist_loss = probe.get("history", {}).get("loss", [])
        phase("text BERT-base streaming fit", got == want
              and probe.get("moved") == probe.get("leaves")
              and all(math.isfinite(v) for v in hist_loss),
              f"launches {got} (want {want}: {layers} layers x {steps} "
              f"steps over {len(shard_steps)} shards); loss {hist_loss}; "
              f"{probe.get('moved')}/{probe.get('leaves')} leaves moved; "
              f"fitTime {bert.get('fitTime')}")
        evaluate("bert_eval", "bert_stream", "tok128_test")
        run("bert_pred", "POST", "/predict/tensorflow", {
            "name": "bert_pred", "parentName": "bert_stream",
            "method": "predict", "methodParameters": {"x": "$tok128_test"}},
            "bert_pred")
        ev_l, pr_l = (jobs[k]["launches"] for k in ("bert_eval",
                                                    "bert_pred"))
        preds = np.asarray(server.ctx.volumes.read_object(
            "predict/tensorflow", "bert_pred"), np.float32)
        phase("text BERT-base evaluate/predict", ev_l["dequantize_rowwise"]
              == pr_l["dequantize_rowwise"] == 1
              and ev_l["flash_fwd"] == layers * eval_batches
              and pr_l["flash_fwd"] == layers * pred_batches
              and preds.shape == (IMDB_ROWS, 2)
              and bool(np.isfinite(preds).all()),
              f"evaluate {ev_l} (want K5 1, K1 {layers} x {eval_batches}), "
              f"predict {pr_l} (want K5 1, K1 {layers} x {pred_batches} "
              f"dispatches); predictions {preds.shape}")
        test_tokens = ShardedDataset(server.ctx.volumes.path_for(
            "transform/text", "tok128_test")).load_shard(0)
        ref = load_artifact(server.ctx.volumes.read_object(
            "train/tensorflow", "bert_stream"), device="cpu").predict(
            test_tokens["tokens"][TEXT_CPU_ROWS])
        cpu_err = float(np.abs(preds[TEXT_CPU_ROWS] - ref).max())
        phase("text predict vs CPU plain path", cpu_err <= CPU_ATOL,
              f"bare $tok128_test (the fit's feature column), rows "
              f"{TEXT_CPU_ROWS}: max|dlogit|={cpu_err:.3g} atol={CPU_ATOL}")
        # 4. Config 3: the LSTM, curves, function/python, t-SNE.
        model("lstm", "models.text", "LSTMClassifier", {})
        train("lstm_stream", "lstm", "tok80", STREAM_BATCH)
        evaluate("lstm_eval", "lstm_stream", "tok80_test")
        for key, parent in (("bert_curves", "bert_stream"),
                            ("lstm_curves", "lstm_stream")):
            run(key, "POST", "/explore/curves",
                {"name": key, "parentName": parent}, key)
        fn = run("tsne_data", "POST", "/function/python", {
            "name": "tsne_data", "function": TSNE_DATA_FUNCTION,
            "functionParameters": {"data": "$tok80_test",
                                   "rows": TSNE_PLOT_ROWS}}, "tsne_data")
        _, fn_rows = request(port, "GET", "/function/python/tsne_data")
        message = [r.get("functionMessage") for r in fn_rows[1:]
                   if "functionMessage" in r]
        run("tsne_plot", "POST", "/explore/scikitlearn", {
            "name": "imdb_tsne",
            "modulePath":
                "learningorchestra_tpu.toolkit.estimators.decomposition",
            "class": "TSNE", "classParameters": {
                "n_components": 2, "learning_rate": TSNE_RATE,
                "random_state": 0},
            "method": "fit_transform",
            "methodParameters": {"x": "$tsne_data.0"},
            "colorBy": "$tsne_data.1"}, "imdb_tsne")
        for key, path in (("bert_curves", "/explore/curves/bert_curves"),
                          ("lstm_curves", "/explore/curves/lstm_curves"),
                          ("tsne", "/explore/scikitlearn/imdb_tsne")):
            status, data = request_raw(port, path)
            images[key] = {"status": status, "bytes": len(data),
                           "size": png_size(data)}
        phase("text images", all(v["status"] == 200 and v["size"] == (
            960, 720) for v in images.values())
              and message == [f"rows {TSNE_PLOT_ROWS}\n"],
              f"{images}; function message {message}; function "
              f"{fn.get('jobState')}")
        # 5. Tensor ingest and the streaming MnistCNN.
        mnist = run("mnist", "POST", "/dataset/tensor", {
            "datasetName": "mnist", "url": f"file://{tmp}/mnist_x.npy",
            "labelsUrl": f"file://{tmp}/mnist_y.npy",
            "shardRows": TEXT_SHARD}, "mnist")
        model("cnn", "models.vision", "MnistCNN", {})
        train("cnn_stream", "cnn", "mnist", MNIST_BATCH)
        # 6. Sharded CSV (Covertype's schema) and the streaming MLP.
        covtype = run("covtype", "POST", "/dataset/csv", {
            "datasetName": "covtype", "url": f"file://{tmp}/covtype.csv",
            "shardRows": COVTYPE_STREAM_SHARD}, "covtype")
        model("mlp", "models.mlp", "MLPClassifier",
              {"hidden_layer_sizes": [256, 256], "num_classes": 8})
        run("mlp_stream", "POST", "/train/tensorflow", {
            "name": "mlp_stream", "parentName": "mlp", "method": "fit",
            "methodParameters": {"x": "$covtype",
                                 "y": "$covtype.Cover_Type", "epochs": 1,
                                 "batch_size": 512}}, "mlp_stream")
        generic = run("generic", "POST", "/dataset/generic", {
            "datasetName": "blob", "url": f"file://{tmp}/mnist_y.npy"},
            "blob")
        stream_fits = {f["class"]: f for f in fits.fits}
        fit_summary = [(c, f["moved"], f["leaves"], f["history"].get("loss"))
                       for c, f in stream_fits.items()]
        phase("text tensor/CSV ingest",
              mnist.get("shards") == -(-MNIST_ROWS // TEXT_SHARD)
              and covtype.get("shards") == -(-COVTYPE_STREAM_ROWS
                                             // COVTYPE_STREAM_SHARD)
              and covtype.get("rows") == COVTYPE_STREAM_ROWS
              and generic.get("sizeBytes") == len(open(
                  f"{tmp}/mnist_y.npy", "rb").read())
              and all(stream_fits.get(c, {}).get("moved")
                      == stream_fits.get(c, {}).get("leaves", -1)
                      for c in ("MnistCNN", "MLPClassifier",
                                "LSTMClassifier")),
              f"mnist {mnist.get('shards')} shards of {mnist.get('rows')} "
              f"rows {mnist.get('featureShape')}; covtype "
              f"{covtype.get('shards')} shards of {covtype.get('rows')} rows"
              f" (cut from 581,012); generic {generic.get('sizeBytes')} B; "
              "streaming fits (class, leaves moved, leaves, losses) "
              f"{fit_summary}")
        # 7. Streaming against in-memory, and one profiled shard.
        tokens = ShardedDataset(server.ctx.volumes.path_for(
            "transform/text", "tok128")).load_shard(0)
        check = stream_vs_memory(tokens["tokens"], tokens["label"], tmp)
        epoch_s = (probe.get("history", {}).get("epoch_time") or [None])[0]
        ev_rows = {k: next((r for r in request(
            port, "GET", f"/evaluate/tensorflow/{k}")[1][1:]
            if "loss" in r), None) for k in ("bert_eval", "lstm_eval")}
        line = {
            "jobs": {k: {"seconds": v["seconds"],
                         "launches": v["launches"]}
                     for k, v in jobs.items()},
            "inputs_s": inputs_s,
            "bpe_train_s": bpe.train_s,
            "encode_rows_per_s": bpe.encode_rows / bpe.encode_s
            if bpe.encode_s else None,
            "bert_streaming": {
                "steps": steps, "epoch_s": epoch_s,
                "samples_per_s": IMDB_ROWS / epoch_s if epoch_s else None,
                "step_ms": 1e3 * epoch_s / steps if epoch_s else None,
                "in_memory_step_ms": in_memory_step_ms,
                "fit_time_s": bert.get("fitTime")},
            "shard_wait_s": {c: (f.get("stream_stats") or {}).get(
                "shard_wait_s") for c, f in stream_fits.items()},
            "profiled_shard": check["profiled_shard"],
            "stream_vs_memory_max_abs": check["max_abs_param"],
            "predict_cpu_max_abs_err": cpu_err,
            "evaluate": ev_rows,
            "train_losses": {c: f["history"].get("loss")
                             for c, f in stream_fits.items()},
            "images": images,
            "reduced": {"covtype_rows": f"{COVTYPE_STREAM_ROWS} of 581012 "
                        "(the sharded CSV is parsed by the native CSV "
                        "engine)",
                        "imdb_rows": f"{IMDB_ROWS} of 25000 per split"},
        }
    finally:
        fits.close()
        bpe.close()
        server.shutdown()
    launches = {k: jobs[k]["launches"] for k in (
        "bert_stream", "bert_eval", "bert_pred", "lstm_stream", "lstm_eval")
        if k in jobs}
    return {"ok": ok, "launches": launches, "line": line}


# -- phase 12: data-parallel training over REST ------------------------------

DIST_JOB = "bert_dist"
DIST_ROWS = 128  # one device against world 2: 4 global batches of 32
# (b) runs plain SGD, so a parameter's change is the sum of its synced
# gradients times the rate: a fault in the sync (skipped, one rank's
# gradient lost, a mean for a sum) shows in the change at its own size,
# where Adam's sign-like first steps would hide a scale fault.  At a
# tenth of this rate the sound reading doubles: updates below a bf16
# copy's spacing round away unevenly (PERF.md section 6).
DIST_SGD_LR = 0.05
# The relative error of one run's parameter change against another's,
# per leaf (update_error); set from the sound runs' reading, far below
# what the planted sync faults read (PERF.md section 6).
SYNC_BAR = 5e-2
# A leaf whose change is below this share of the model's RMS change per
# element is held at that floor: its change is rounding noise (the
# attention key bias has an exactly zero gradient).
SYNC_FLOOR = 0.1
DIST_BUILDER = (
    "def ranks(rank, world_size):\n"
    "    import torch\n"
    "    return {'rank': rank, 'world': world_size,\n"
    "            'device': torch.cuda.get_device_name()}\n")


class TrainerProbe:
    """Keeps each ``DistributedTrainer``'s per-rank stats (launches, step
    and gradient-sync ms, spawn-to-first-step seconds) while the phase
    runs; the REST job's metadata keeps only the JAX package's keys."""

    def __init__(self):
        from learningorchestra_tpu_torch.parallel import distributed

        self.cls, self.real = distributed.DistributedTrainer, \
            distributed.DistributedTrainer.fit
        self.fits: list = []
        real, probe = self.real, self

        def fit(trainer, *args, **kwargs):
            out = real(trainer, *args, **kwargs)
            probe.fits.append({"world": trainer.mesh.size,
                               "backend": trainer.backend,
                               "rank_stats": trainer.rank_stats,
                               "history": dict(trainer.history)})
            return out

        self.cls.fit = fit

    def close(self):
        self.cls.fit = self.real


def rank_summary(fit: dict, steps: int) -> dict:
    """Per rank: launches, the median step and gradient-sync ms past the
    first step, and the all-reduce's share of a step, measured."""
    out = []
    for s in fit["rank_stats"]:
        step = float(np.median(s["step_ms"][1:] or s["step_ms"]))
        sync = float(np.median(s["sync_ms"][1:] or s["sync_ms"]))
        out.append({"rank": s["rank"], "device": s["device"],
                    "launches": s["launches"], "steps": len(s["step_ms"]),
                    "step_ms": step, "sync_ms": sync,
                    "allreduce_share": sync / step,
                    "spawn_to_first_step_s": s["spawn_to_first_step_s"]})
    want = REST_LAYERS * steps
    ok = len(out) == fit["world"] and all(
        r["steps"] == steps and all(r["launches"][k] == want for k in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        for r in out)
    return {"ok": ok, "ranks": out, "want_per_rank": want}


def update_error(init, got, want, scale: float = 1.0) -> dict:
    """How far ``scale`` times ``got``'s parameter change from ``init`` is
    from ``want``'s: per leaf ||scale*d_got - d_want|| / ||d_want|| (the
    denominator floored at ``SYNC_FLOOR`` of the model's RMS change per
    element), its largest leaf, and the same ratio over the whole
    model."""
    leaves = []
    for (path, p0), (_, pg), (_, pw) in zip(_flat(init), _flat(got),
                                            _flat(want)):
        p0, pg, pw = (torch.as_tensor(t).detach().cpu().double()
                      for t in (p0, pg, pw))
        leaves.append((".".join(path),
                       float((scale * (pg - p0) - (pw - p0)).norm()),
                       float((pw - p0).norm()), p0.numel()))
    num = math.sqrt(sum(n * n for _, n, _, _ in leaves))
    den = math.sqrt(sum(d * d for _, _, d, _ in leaves))
    if not den:  # no change to hold against
        return {"max_leaf": math.inf, "leaf": None, "model": math.inf,
                "leaves": len(leaves)}
    rms = den / math.sqrt(sum(k for *_, k in leaves))
    worst = max((n / max(d, SYNC_FLOOR * rms * math.sqrt(k)), name)
                for name, n, d, k in leaves)
    return {"max_leaf": worst[0], "leaf": worst[1], "model": num / den,
            "leaves": len(leaves)}


def max_tree_diff(a, b) -> tuple:
    pairs = list(zip(_flat(a), _flat(b)))
    diff = max(float((torch.as_tensor(u).detach().float().cpu()
                      - torch.as_tensor(v).detach().float().cpu())
                     .abs().max())
               for (_, u), (_, v) in pairs)
    return diff, len(pairs)


def run_distributed(tmp, in_memory_step_ms) -> dict:
    """Phase 12: BERT-base data-parallel on the card.  (a) World 1 over
    REST (``POST /train/horovod``: NCCL, one leased card) with a
    monitoring session, a predict on its int8 artifact, its f32 final
    checkpoint against a single-device fit; (b) world 2 (gloo, both
    ranks on cuda:0) through ``DistributedTrainer`` against one device in
    this process on the same rows; (c) the distributed builder; (d) a CSV
    by URL."""
    import functools
    import http.server
    import threading

    from learningorchestra_tpu_torch import convert
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.parallel import DistributedTrainer
    from learningorchestra_tpu_torch.train import checkpoint as ckpt
    from learningorchestra_tpu_torch.train.neural import load_artifact

    torch.cuda.empty_cache()
    csv = f"{tmp}/www/tokens.csv"
    os.makedirs(f"{tmp}/www")
    x, y = write_token_csv(csv)
    vols = f"{tmp}/volumes"
    server = APIServer(server_config(vols), device="cuda")
    port = server.start_background()
    probe = TrainerProbe()
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(
            http.server.SimpleHTTPRequestHandler, directory=f"{tmp}/www"))
    httpd.RequestHandlerClass.log_message = lambda *a: None
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    ok, line, launches = True, {}, {}

    def check(name, good, detail):
        nonlocal ok
        phase(name, good, detail)
        ok &= bool(good)

    try:
        for verb, path, body, name in (
                ("POST", "/dataset/csv",
                 {"datasetName": "tokens", "url": f"file://{csv}"}, "tokens"),
                ("POST", "/transform/projection",
                 {"projectionName": "tokens_x", "datasetName": "tokens",
                  "fields": REST_FIELDS}, "tokens_x"),
                ("POST", "/model/tensorflow",
                 {"modelName": "bert", "class": "BertModel",
                  "modulePath": "learningorchestra_tpu.models.text",
                  "classParameters": REST_MODEL}, "bert")):
            status, meta, _, _ = rest_job(port, verb, path, body, name)
            check(f"distributed setup {name}",
                  meta.get("jobState") == "finished", f"{verb} {path} -> "
                  f"{status}, jobState {meta.get('jobState')}")

        # (a) world 1 over REST, traced into its monitoring session.
        steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // TRAIN_SHAPE[0])
        status, meta, secs, counts = rest_job(
            port, "POST", "/train/horovod",
            {"name": DIST_JOB, "parentName": "bert",
             "trainingParameters": {
                 "x": "$tokens_x", "y": "$tokens.label",
                 "epochs": TRAIN_EPOCHS, "batch_size": TRAIN_SHAPE[0],
                 "shuffle": False, "quantize_checkpoint": True},
             "monitoringPath": f"{DIST_JOB}_logs"}, DIST_JOB)
        rest_fit = probe.fits[-1] if probe.fits else {"rank_stats": [],
                                                      "world": 0}
        ranks = rank_summary(rest_fit, steps)
        _, rows = request(port, "GET", f"/train/horovod/{DIST_JOB}")
        history = [r for r in rows if r.get("docType") == "history"]
        launches["rest_train_parent"] = counts
        launches["rest_train_ranks"] = [r["launches"]
                                        for r in ranks["ranks"]]
        check("distributed rest train",
              meta.get("jobState") == "finished"
              and meta.get("distributed") is True
              and meta.get("meshDevices") == 1 and ranks["ok"]
              and rest_fit.get("backend") == "nccl"
              and len(history) == TRAIN_EPOCHS
              and all("samples_per_sec" in r and math.isfinite(r["loss"])
                      for r in history)
              and counts["quantize_rowwise"] == 1,
              f"POST /train/horovod -> {status}, {meta.get('jobState')} in "
              f"{secs:.2f}s, meshDevices {meta.get('meshDevices')}, backend "
              f"{rest_fit.get('backend')}; rank launches "
              f"{launches['rest_train_ranks']} (want {ranks['want_per_rank']}"
              f" each of K1/K2/K3: {REST_LAYERS} layers x {steps} steps); "
              f"parent {counts} (K4 once at the int8 publication); history "
              f"{[(r.get('loss'), r.get('samples_per_sec')) for r in history]}"
              + ("" if meta.get("jobState") == "finished"
                 else f"; exception {meta.get('exception')}"))
        _, session = request(port, "GET",
                             f"/monitoring/tensorflow/{DIST_JOB}_logs")
        files = [f for _, _, fs in os.walk(session.get("logdir") or
                                           "/nonexistent") for f in fs]
        trace = [f for f in files if f.endswith(".pt.trace.json")]
        check("distributed monitoring session",
              f"{DIST_JOB}.csv" in files and trace
              and any(f.startswith("events.out.tfevents.") for f in files),
              f"logdir {session.get('logdir')}: {sorted(files)}")
        line["monitoring_files"] = sorted(files)

        status, pmeta, pred_s, pcounts = rest_job(
            port, "POST", "/predict/tensorflow",
            {"name": "bert_dist_pred", "parentName": DIST_JOB,
             "method": "predict", "methodParameters": {"x": "$tokens_x"}},
            "bert_dist_pred")
        launches["rest_predict"] = pcounts
        preds = np.asarray([r["result"] for r in rest_rows(
            port, "/predict/tensorflow/bert_dist_pred") if "result" in r],
            np.float32)
        artifact = server.ctx.volumes.read_object("train/tensorflow",
                                                  DIST_JOB)
        ref = load_artifact(artifact, device="cpu").predict(
            x[REST_CPU_ROWS])
        pred_err = float(np.abs(preds[REST_CPU_ROWS] - ref).max()) \
            if preds.shape == (TRAIN_ROWS, 2) else float("inf")
        check("distributed predict vs CPU plain path",
              pmeta.get("jobState") == "finished" and pred_err <= CPU_ATOL
              and pcounts["dequantize_rowwise"] == 1
              and pcounts["flash_fwd"] == REST_LAYERS,
              f"predict on {DIST_JOB}'s int8 artifact: launches {pcounts} "
              f"(want K5 1, K1 {REST_LAYERS} x 1 batch); rows "
              f"{REST_CPU_ROWS} max|dlogit| {pred_err:.3g} atol {CPU_ATOL}")

        # Its final f32 checkpoint against a single-device fit (the same
        # model artifact, rows and order).
        final = torch.load(f"{vols}/_checkpoints/{DIST_JOB}/step_"
                           f"{TRAIN_EPOCHS}/{ckpt.STATE_FILE}",
                           map_location="cpu", weights_only=True)
        single = server.ctx.volumes.load_estimator("model/tensorflow",
                                                   "bert", device="cuda")
        init = convert.to_host(convert.flax_tree(single.module))
        single.fit(x, y, epochs=TRAIN_EPOCHS, batch_size=TRAIN_SHAPE[0],
                   shuffle=False)
        want = convert.to_host(convert.flax_tree(single.module))
        rest_diff, leaves = max_tree_diff(final["params"], want)
        rest_update = update_error(init, final["params"], want)
        loss_diff = max(abs(a["loss"] - b) for a, b in zip(
            history, single.history["loss"]))
        del single, want
        check("distributed world 1 vs single device",
              leaves > 0 and rest_diff <= CRASH_BAR and loss_diff <= CRASH_BAR
              and rest_update["max_leaf"] <= SYNC_BAR,
              f"max|world-1 REST - BertModel.fit| over {leaves} leaves = "
              f"{rest_diff:.3g}, losses {loss_diff:.3g} (expected 0; bar "
              f"{CRASH_BAR}); parameter change vs the single fit's "
              f"{rest_update} (bar {SYNC_BAR} per leaf)")
        line.update(rest_train_s=secs, rest_fit_time_s=meta.get("fitTime"),
                    rest_predict_s=pred_s, rest_history=history,
                    rest_ranks=ranks["ranks"], predict_cpu_max_abs_err=pred_err,
                    world1_rest_vs_single_max_abs_diff=rest_diff,
                    world1_rest_vs_single_loss_diff=loss_diff,
                    world1_rest_vs_single_update=rest_update)

        # (b) world 2 through the trainer against one device on the same
        # rows, under plain SGD from the same initial parameters.  (a)
        # holds world 1 (NCCL) to one device bit for bit, so the one
        # device runs in this process: a spawned world-1 trainer cost
        # 27.5 s of the phase (PERF.md section 4).
        steps = -(-DIST_ROWS // TRAIN_SHAPE[0])
        worlds = {}
        one = server.ctx.volumes.load_estimator("model/tensorflow", "bert",
                                                device="cuda")
        one.compile(optimizer="sgd", learning_rate=DIST_SGD_LR)
        zero_kernel_counts()
        t0 = time.perf_counter()
        one.fit(x[:DIST_ROWS], y[:DIST_ROWS], epochs=1,
                batch_size=TRAIN_SHAPE[0], shuffle=False)
        secs = time.perf_counter() - t0
        counts = kernel_counts()
        launches["one_device"] = [counts]
        want = REST_LAYERS * steps
        worlds["world1"] = {
            "seconds": secs, "backend": "one device, this process",
            "history": dict(one.history),
            "params": convert.to_host(convert.flax_tree(one.module)),
            "ranks": [{"device": "cuda:0", "launches": counts}]}
        check("distributed one device", all(
            counts[k] == want for k in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")),
              f"BertModel.fit in this process: {secs:.2f}s, {steps} SGD "
              f"steps; launches {counts} (want {want} of K1/K2/K3)")
        del one
        devices = ["cuda:0", "cuda:0"]
        est = server.ctx.volumes.load_estimator("model/tensorflow", "bert",
                                                device="cuda")
        est.compile(optimizer="sgd", learning_rate=DIST_SGD_LR)
        trainer = DistributedTrainer(est, devices=devices)
        t0 = time.perf_counter()
        trainer.fit(x[:DIST_ROWS], y[:DIST_ROWS], epochs=1,
                    batch_size=TRAIN_SHAPE[0], shuffle=False)
        secs = time.perf_counter() - t0
        summary = rank_summary(probe.fits[-1], steps)
        worlds["world2"] = {"seconds": secs, "backend": trainer.backend,
                            "history": dict(trainer.history),
                            "params": convert.to_host(
                                convert.flax_tree(est.module)), **summary}
        launches["trainer_world2"] = [r["launches"]
                                      for r in summary["ranks"]]
        check("distributed trainer world2", summary["ok"],
              f"{trainer.backend}, {len(devices)} rank(s) on {devices}: "
              f"{secs:.2f}s; per rank {summary['ranks']} (want "
              f"{summary['want_per_rank']} launches of K1/K2/K3)")
        del est, trainer
        w1, w2 = worlds["world1"]["params"], worlds["world2"]["params"]
        w2_diff, leaves = max_tree_diff(w1, w2)
        sync = update_error(init, w2, w1)
        check("distributed world 2 vs one device",
              worlds["world2"]["backend"] == "gloo"
              and w2_diff <= CRASH_BAR and sync["max_leaf"] <= SYNC_BAR,
              f"max|world 2 (gloo) - one device| over {leaves} leaves = "
              f"{w2_diff:.3g} (bar {CRASH_BAR}; the reduction order "
              f"differs); SGD parameter change vs one device's {sync} (bar "
              f"{SYNC_BAR} per leaf); losses "
              f"{worlds['world1']['history'].get('loss')} vs "
              f"{worlds['world2']['history'].get('loss')}")
        # What the same check reads for planted sync faults.  A world 2
        # that skipped the sync, or lost rank 1's gradient, steps rank 0
        # on its own rows [0, 16) of each batch with the loss over the
        # global 32 rows: a single-device SGD fit of those rows at batch
        # 16 and half the rate.  A mean for the sum halves every change.
        half = TRAIN_SHAPE[0] // 2
        rows = np.concatenate([np.arange(b, b + half) for b in range(
            0, DIST_ROWS, TRAIN_SHAPE[0])])
        alone = server.ctx.volumes.load_estimator("model/tensorflow",
                                                  "bert", device="cuda")
        alone.compile(optimizer="sgd", learning_rate=DIST_SGD_LR / 2)
        alone.fit(x[rows], y[rows], epochs=1, batch_size=half,
                  shuffle=False)
        faults = {"sync_skipped_or_rank1_lost": update_error(
                      init, convert.to_host(convert.flax_tree(alone.module)),
                      w1),
                  "mean_for_sum": update_error(init, w2, w1, scale=0.5)}
        del alone
        check("distributed sync faults read above the bar",
              all(f["max_leaf"] > SYNC_BAR for f in faults.values()),
              f"planted faults {faults} (bar {SYNC_BAR} per leaf)")
        for key, w in worlds.items():
            line[key] = {k: w[k] for k in ("seconds", "backend", "ranks")}
            line[key]["samples_per_sec"] = w["history"].get(
                "samples_per_sec")
        line.update(world2_vs_world1_max_abs_diff=w2_diff,
                    world2_vs_world1_update=sync, sync_faults=faults,
                    sync_bar=SYNC_BAR)

        # (c) the distributed builder: one function on two ranks.
        status, bmeta, build_s, _ = rest_job(
            port, "POST", "/builder/pytorch",
            {"name": "dist_builder", "function": DIST_BUILDER,
             "nWorkers": 2}, "dist_builder")
        _, brows = request(port, "GET", "/builder/pytorch/dist_builder")
        results = sorted((r["rank"], r["result"]) for r in brows
                         if "result" in r)
        check("distributed builder",
              bmeta.get("jobState") == "finished"
              and [r for r, _ in results] == [0, 1]
              and all(res["device"] == torch.cuda.get_device_name(0)
                      for _, res in results),
              f"POST /builder/pytorch -> {status}, {bmeta.get('jobState')} "
              f"in {build_s:.2f}s; rows {results}")

        # (d) the token CSV by URL, against its file ingest.
        url = f"http://127.0.0.1:{httpd.server_address[1]}/tokens.csv"
        status, umeta, url_s, _ = rest_job(
            port, "POST", "/dataset/csv",
            {"datasetName": "tokens_url", "url": url}, "tokens_url")
        strip = [[{k: v for k, v in r.items() if k != "_id"}
                  for r in rest_rows(port, f"/dataset/csv/{name}")[1:]
                  if r.get("docType") != "execution"]
                 for name in ("tokens_url", "tokens")]
        check("distributed URL source",
              umeta.get("jobState") == "finished"
              and umeta.get("rows") == TRAIN_ROWS and strip[0] == strip[1],
              f"POST /dataset/csv from {url} -> {status}, "
              f"{umeta.get('jobState')} in {url_s:.2f}s, rows "
              f"{umeta.get('rows')}, equal to the file ingest: "
              f"{strip[0] == strip[1]}")
        line.update(builder_s=build_s, url_ingest_s=url_s,
                    in_memory_step_ms=in_memory_step_ms)
    finally:
        probe.close()
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
    return {"ok": ok, "line": line, "launches": launches}


# -- phase 13: the decoder LM and streaming generation -----------------------

# GPT-2 small's published widths (openai-community/gpt2 config.json:
# n_embd 768, n_layer 12, n_head 12, n_inner 3072, vocab 50257,
# n_positions 1024); the JAX DecoderLM's untied biased head, LayerNorm eps
# 1e-6 and pad id 0 stay.
GPT2 = {"vocab_size": 50257, "hidden_dim": 768, "num_layers": 12,
        "num_heads": 12, "max_len": 1024}
# (e): rotary positions, grouped-query attention and a window, 2 layers.
GPT2_ROPE = dict(GPT2, num_layers=2, num_kv_heads=4, attention_window=256,
                 positional="rope")
DEC_ROWS, DEC_BATCH, DEC_EPOCHS, DEC_LR = 64, 8, 2, 3e-4
DEC_T = 1024
DEC_PERIOD = 128  # the cyclic pattern the fit learns
DEC_CPU_T = 256  # (a)'s CPU side at this length (stays under ~30 s)
DEC_PROMPTS = 8
DEC_PROMPT_LENS = (16, 256)
DEC_NEW = 64
DEC_SSE = 4
DEC_ABORT_AFTER = 5
# (d): the cached decode's f32 step logits against a full causal forward
# of the final buffer: |d| <= DEC_LOGIT_BAR * (1 + |ref|).  The path is f32
# end to end; K1's split-TF32 error (<= 2e-5 on O) rides 12 layers and a
# 768 -> 50257 head.
DEC_LOGIT_BAR = 1e-3
DEC_MODEL = "gpt2_lm"
DEC_DEVICE = "cuda"


def decoder_pattern() -> np.ndarray:
    """The fixed cycle of ids in 1..50256 the rows are cut from."""
    rng = np.random.default_rng(13)
    return rng.permutation(np.arange(1, GPT2["vocab_size"]))[:DEC_PERIOD]


def decoder_rows(n: int, t: int, seed: int) -> np.ndarray:
    """``n`` rows of length ``t``, each at a seeded offset into the cycle."""
    cyc = decoder_pattern()
    offs = np.random.default_rng(seed).integers(0, DEC_PERIOD, n)
    idx = (offs[:, None] + np.arange(t)[None, :]) % DEC_PERIOD
    return cyc[idx].astype(np.int32)


def decoder_data():
    """(a)'s 2 rows (the second with a pad tail) and (b)'s fit rows; the
    targets are the next tokens, pad 0 at the end."""
    x = decoder_rows(DEC_ROWS, DEC_T, seed=1)
    y = np.concatenate([x[:, 1:], np.zeros((DEC_ROWS, 1), np.int32)], 1)
    return x, y


def decoder_prompts() -> list:
    rng = np.random.default_rng(21)
    lens = rng.integers(DEC_PROMPT_LENS[0], DEC_PROMPT_LENS[1] + 1,
                        DEC_PROMPTS)
    lens[0], lens[1] = DEC_PROMPT_LENS  # both ends of the range
    return [decoder_rows(1, int(n), seed=100 + i)[0].tolist()
            for i, n in enumerate(lens)]


def step_logits_check(est, prompts, new: int, label: str) -> dict:
    """(d): ``generate`` through the KV cache with every step's f32 logits
    captured, against a full causal f32 forward (K1) of the buffer it
    produced, at every generated position."""
    steps = []

    def hook(module, args, kwargs, out):
        if kwargs.get("cache") is not None:
            steps.append(out[:, 0].float())

    handle = est.module.register_forward_hook(hook, with_kwargs=True)
    worst, ok, lines = 0.0, True, []
    try:
        for prompt in prompts:
            steps.clear()
            buf = est.generate(np.asarray([prompt], np.int32),
                               max_new_tokens=new)
            t0 = len(prompt)
            with torch.inference_mode():
                ref = est.module(torch.from_numpy(buf).to(DEC_DEVICE))[0]
                ref = ref.float()
            got = torch.cat(steps[t0 - 1:], 0)  # positions t0-1..total-2
            want = ref[t0 - 1:buf.shape[1] - 1]
            diff = (got - want).abs()
            excess = float((diff - DEC_LOGIT_BAR * (1 + want.abs())).max())
            err = float(diff.max())
            worst = max(worst, err)
            ok &= excess <= 0 and bool(torch.isfinite(got).all())
            lines.append(f"t0={t0} total={buf.shape[1]}: max|d|={err:.3g}")
    finally:
        handle.remove()
    phase(f"decoder cache vs full forward {label}", ok,
          f"{'; '.join(lines)}; bar {DEC_LOGIT_BAR}*(1+|ref|), f32 step "
          f"logits at every generated position vs one causal forward (K1 "
          f"f32) of the final buffer")
    return {"max_abs_err": worst, "ok": ok}


def first_divergence(a: list, b: list):
    """The first index where two token lists differ (None: equal)."""
    for i, (u, v) in enumerate(zip(a, b)):
        if u != v:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def read_sse(port, body, on_token=None, model=DEC_MODEL):
    """POST a streaming /generate and read its SSE body: (status, events
    [(name, doc, arrival s)], seconds from the request to each event)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", f"/api/learningOrchestra/v1/serve/{model}"
                     "/generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, [("error", json.loads(resp.read()), 0.0)]
        events, name = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().strip()
            if line.startswith("event:"):
                name = line[6:].strip()
            elif line.startswith("data:"):
                doc = json.loads(line[5:].strip())
                events.append((name, doc, time.perf_counter() - t0))
                if name == "token" and on_token is not None:
                    on_token(doc, len([e for e in events
                                       if e[0] == "token"]))
        return 200, events
    finally:
        conn.close()


def time_decode_steps(est, warm: dict, reps: int = 10,
                      rows=None) -> dict:
    """Each (S, Tk) cell the engine stepped, timed on its own: a pool of S
    live slots at position Tk/2, stepped by the cell's program as the
    engine steps it (a CUDA graph replay after one copy of the step's
    inputs) and, in the same run, by the eager ``build_step`` called
    directly.  Host-paced ms is what a caller waits per step (CUDA events
    around ``reps`` steps, launches not hidden).  Device ms: the graph's
    bare replays queued behind a device sleep; the eager step's kernel
    times summed from torch.profiler (a device sleep cannot hide a launch
    rate that slow).  Their gap is the device's idle share.  ``rows(n,
    t, seed)`` fills the pools' tokens (default: ``decoder_rows``)."""
    from torch.profiler import ProfilerActivity, profile

    from learningorchestra_tpu_torch.serve.decode.pages import (
        DecodeStepProgram,
        PagePool,
        build_step,
    )

    out = {}
    for nslots, kvlen in sorted(warm):
        module = est.module
        program = DecodeStepProgram(nslots, kvlen)
        pool = PagePool(kvlen, nslots)
        pool._alloc(lambda want: module.init_cache(
            want, kvlen, per_row=True, device=DEC_DEVICE), nslots)
        pool.buf.copy_(torch.from_numpy((rows or decoder_rows)(
            nslots, kvlen, seed=5)).to(DEC_DEVICE).long())
        pos = np.full(nslots, kvlen // 2, np.int64)
        t0s = np.full(nslots, kvlen + 1, np.int64)
        live = np.ones(nslots, bool)
        step = build_step(module, nslots, kvlen)
        dpos = torch.from_numpy(pos).to(DEC_DEVICE)
        dt0s = torch.from_numpy(t0s).to(DEC_DEVICE)
        dlive = torch.from_numpy(live).to(DEC_DEVICE)

        def graph_step():
            program(module, pool, pos, t0s, live)

        def eager_step():
            step(pool.cache, pool.buf, dpos, dt0s, dlive)

        with torch.no_grad():
            graph_step()  # captures
            cell = {"graph_host_paced_ms": time_ms(graph_step, reps=reps,
                                                   hide_launch=False),
                    "graph_device_ms": time_ms(pool.graph.graph.replay,
                                               reps=reps),
                    "capture_ms": 1e3 * pool.graph.capture_s,
                    "graph_pool_bytes": pool.graph.pool_bytes,
                    "eager_host_paced_ms": time_ms(eager_step, reps=reps,
                                                   hide_launch=False)}
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        eager_step()
                    torch.cuda.synchronize()
                cell["eager_device_ms"] = sum(
                    device_kernels(prof).values()) / reps
            except Exception as exc:  # noqa: BLE001 — where CUPTI tracing
                # is unavailable the device time is not measured.
                cell["eager_device_ms"] = None
                print(f"[info] decode step profile: {exc!r}", flush=True)
        for kind in ("graph", "eager"):
            host, dev = cell[f"{kind}_host_paced_ms"], cell[
                f"{kind}_device_ms"]
            cell[f"{kind}_idle_share"] = None if dev is None else max(
                0.0, 1 - dev / host)
        out[f"s{nslots}_k{kvlen}"] = cell
        del pool, program, step
    return out


def decoder_throughput(server, est, prompts) -> dict:
    """Continuous batching against sequential solo decodes, as the JAX
    package's bench measures it: 8 prompts, every one submitted at once to
    the engine (best of 2 passes), against one solo ``generate`` after
    another (one pass); warm."""
    new = DEC_NEW
    eng = server.serving.decode
    est.generate(np.asarray([prompts[0]], np.int32), max_new_tokens=new)
    t0 = time.perf_counter()
    for p in prompts:
        est.generate(np.asarray([p], np.int32), max_new_tokens=new)
    seq = len(prompts) * new / (time.perf_counter() - t0)
    eng.generate(DEC_MODEL, prompts, max_new_tokens=new)  # warm
    engine = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        eng.generate(DEC_MODEL, prompts, max_new_tokens=new)
        engine = max(engine, len(prompts) * new / (time.perf_counter() - t0))
    return {"prompts": len(prompts), "prompt_len": len(prompts[0]),
            "new_tokens": new, "sequential_tok_s": seq,
            "engine_tok_s": engine, "speedup": engine / seq}


def run_decoder(tmp, card: str) -> dict:
    """Phase 13: the GPT-2-small-width DecoderLM through the port's entry
    points: (a) one f32 step on the card against the CPU, (b) ``fit``,
    (c) an int8 artifact served by ``APIServer`` over /generate (JSON, SSE
    with mid-flight admission, an abort, a sampled request), (d) the cached
    decode's logits against a full causal forward, (e) the same for a
    rope + GQA + window configuration, (f) the ``decoder`` line."""
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.models.text import DecoderLM
    from learningorchestra_tpu_torch.ops import quant
    from learningorchestra_tpu_torch.ops.quant import QuantizedLeaf
    from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE
    from learningorchestra_tpu_torch.store.volumes import VolumeStorage

    t_phase = time.perf_counter()
    line: dict = {}
    launches: dict = {}
    t0 = time.perf_counter()
    est = DecoderLM(**GPT2, learning_rate=DEC_LR, seed=0, device=DEC_DEVICE)
    n_params = sum(p.numel() for p in est.module.parameters())
    line["build_s"] = time.perf_counter() - t0
    line["params"] = n_params
    x, y = decoder_data()

    # (a) one f32 step, card against the CPU, 2 rows (the second with a
    # pad tail) at DEC_CPU_T.
    xa = x[:2, :DEC_CPU_T].copy()
    xa[1, DEC_CPU_T * 3 // 4:] = 0
    ya = np.concatenate([xa[:, 1:], np.zeros((2, 1), np.int32)], 1)
    line["step_vs_cpu"] = step_vs_cpu(
        est, xa, ya, "decoder step vs CPU plain path",
        f"DecoderLM GPT-2 small widths ({n_params / 1e6:.1f} M parameters) "
        f"f32, 2 rows (second with a pad tail), T shortened to {DEC_CPU_T} "
        f"of {DEC_T} for the CPU side")

    # (b) fit: bf16 compute on f32 masters, counters at 0 just before.
    before = [p.detach().clone() for p in est.module.parameters()]
    marks = []

    def mark_epoch(epoch, metrics, model):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    zero_kernel_counts()
    t0 = time.perf_counter()
    est.fit(x, y, epochs=DEC_EPOCHS, batch_size=DEC_BATCH,
            callbacks=[mark_epoch])
    fit_s = time.perf_counter() - t0
    launches["train"] = kernel_counts()
    per_epoch = -(-DEC_ROWS // DEC_BATCH)
    steps = DEC_EPOCHS * per_epoch
    layers = GPT2["num_layers"]
    losses = list(est.history["loss"])
    moved = sum(1 for p, p0 in zip(est.module.parameters(), before)
                if not torch.equal(p.detach(), p0))
    del before
    finite = all(math.isfinite(v) for v in losses)
    epoch2_ms = marks[0].elapsed_time(marks[1])
    step_ms = epoch2_ms / per_epoch
    counts = launches["train"]
    want = {"flash_fwd": layers * steps, "flash_bwd_dq": layers * steps,
            "flash_bwd_dkv": layers * steps}
    phase("decoder fit", finite and losses[-1] < losses[0]
          and moved == len(list(est.module.parameters())),
          f"{DEC_ROWS} rows T={DEC_T} (a {DEC_PERIOD}-token cycle), batch "
          f"{DEC_BATCH}, {DEC_EPOCHS} epochs x {per_epoch} steps, bf16 / f32 "
          f"masters, lr {DEC_LR}: loss {losses}, perplexity "
          f"{est.history.get('perplexity')}; {moved} parameters moved; fit "
          f"{fit_s:.2f}s, epoch 2 step {step_ms:.2f} ms")
    phase("decoder fit launch counters",
          all(counts[k] == v for k, v in want.items()),
          f"{ {k: counts[k] for k in want} }; expected {layers} x {steps} "
          "steps each (causal K1 forward, K2/K3 backward)")
    tokens = DEC_ROWS * DEC_T
    line["fit"] = {"losses": losses, "fit_s": fit_s, "step_ms": step_ms,
                   "tokens_per_s": tokens / (epoch2_ms / 1e3),
                   "launches": {k: counts[k] for k in want}}
    try:
        line["fit"]["profile"] = profile_step(
            est, x[:DEC_BATCH], y[:DEC_BATCH], TRAIN_FAMILIES)
    except Exception as exc:  # noqa: BLE001 — where CUPTI tracing is
        # unavailable this breakdown is reported as not measured.
        line["fit"]["profile"] = {"not_measured": repr(exc)}

    # (c) publish int8 (K4), load on the server (K5), serve /generate.
    prompts = decoder_prompts()
    volumes = VolumeStorage(tmp)
    zero_kernel_counts()
    t0 = time.perf_counter()
    artifact = est.to_artifact(quantize=True)
    volumes.save_object(ARTIFACT_TYPE, DEC_MODEL, artifact)
    launches["publish"] = kernel_counts()
    line["artifact_save_s"] = time.perf_counter() - t0
    leaves = sum(1 for _ in _leaves_of(artifact["state"]["params"],
                                       QuantizedLeaf))
    server = APIServer(server_config(tmp), device=DEC_DEVICE)
    port = server.start_background()
    try:
        zero_kernel_counts()
        t0 = time.perf_counter()
        status, body = request(port, "POST", f"/serve/{DEC_MODEL}/load")
        launches["load"] = kernel_counts()
        line["load_s"] = time.perf_counter() - t0
        n_launch = -(-leaves // quant.MAX_LEAVES)
        phase("decoder publish and load",
              status == 200 and launches["publish"]["quantize_rowwise"]
              == launches["load"]["dequantize_rowwise"] == n_launch == 1,
              f"int8 artifact of {leaves} leaves (the head's (768, 50257) "
              f"among them): K4 {launches['publish']['quantize_rowwise']} "
              f"launch, K5 {launches['load']['dequantize_rowwise']} launch "
              f"(expected 1 each); save {line['artifact_save_s']:.2f}s, "
              f"load {line['load_s']:.2f}s -> {status}")
        served = server.serving.registry.get(DEC_MODEL).estimator

        # JSON: 8 prompts of 16..256 tokens, 64 new each.
        zero_kernel_counts()
        t0 = time.perf_counter()
        status, body = request(port, "POST", f"/serve/{DEC_MODEL}/generate",
                               {"prompts": prompts, "maxNewTokens": DEC_NEW})
        json_s = time.perf_counter() - t0
        launches["generate"] = kernel_counts()
        toks = body.get("tokens", [])
        good = status == 200 and len(toks) == DEC_PROMPTS and all(
            len(t) == len(p) + DEC_NEW and t[:len(p)] == p
            and all(0 <= v < GPT2["vocab_size"] for v in t)
            for t, p in zip(toks, prompts))
        phase("decoder generate JSON", good
              and launches["generate"]["flash_fwd"] == 0,
              f"{DEC_PROMPTS} prompts of {[len(p) for p in prompts]} tokens,"
              f" {DEC_NEW} new each -> {status} in {json_s:.2f}s; the decode "
              f"steps launched K1 {launches['generate']['flash_fwd']} times "
              "(expected 0: one query attends the cache in plain torch)")
        # The engine's tokens against in-process solo decodes.
        solo = [served.generate(np.asarray([p], np.int32),
                                max_new_tokens=DEC_NEW)[0].tolist()
                for p in prompts]
        div = [first_divergence(t[len(p):], s[len(p):])
               for t, p, s in zip(toks, prompts, solo)]
        pattern = {int(a): int(b) for a, b in zip(
            decoder_pattern(), np.roll(decoder_pattern(), -1))}
        learned = [float(np.mean([pattern.get(t[i - 1]) == t[i]
                                  for i in range(len(p), len(t))]))
                   for t, p in zip(toks, prompts)]
        line["engine_vs_solo_first_divergence"] = div
        line["pattern_accuracy"] = learned
        print(f"[info] decoder engine vs solo: first divergent new token "
              f"per prompt {div} (None: equal); share of new tokens that "
              f"follow the cycle {learned}", flush=True)

        # SSE: 4 streams, the last 2 opened while the first 2 are mid-
        # flight (admission into running pools).
        # The late two share KV buckets with the early two: admission
        # into pools with a stream mid-flight.
        sse_prompts = [prompts[0], prompts[1], prompts[1][:200],
                       prompts[0][:20]]
        first_tok = [threading.Event() for _ in range(DEC_SSE)]
        results = [None] * DEC_SSE

        def sse(i):
            results[i] = read_sse(
                port, {"prompts": [sse_prompts[i]], "stream": True,
                       "maxNewTokens": DEC_NEW},
                on_token=lambda doc, n, i=i: first_tok[i].set())

        threads = [threading.Thread(target=sse, args=(i,))
                   for i in range(DEC_SSE)]
        # The registry's decode families around the streams: phase 20 (c)
        # holds their deltas to what the streams received.
        registry_before = decode_registry(DEC_MODEL)
        for th in threads[:2]:
            th.start()
        first_tok[0].wait(120)
        midflight = not any(results[:2])  # neither has finished yet
        for th in threads[2:]:
            th.start()
        for th in threads:
            th.join(300)
        registry_after = decode_registry(DEC_MODEL)
        line["registry_sse"] = {
            key: registry_after[key] - registry_before[key]
            for key in registry_after}
        line["registry_sse"]["tokens_received"] = sum(
            sum(1 for n, _, _ in (res or (0, []))[1] if n == "token")
            for res in results)
        line["registry_sse"]["streams"] = DEC_SSE
        ttft, itl, sse_ok, sse_div = [], [], True, []
        for i, res in enumerate(results):
            status, events = res or (0, [])
            tok = [(d["t"], s) for n, d, s in events if n == "token"]
            names = [n for n, _, _ in events]
            sse_ok &= status == 200 and names[:1] == ["open"] and \
                names[-1:] == ["done"] and len(tok) == DEC_NEW
            if tok:
                ttft.append(tok[0][1] * 1e3)
                itl += [(b - a) * 1e3 for (_, a), (_, b) in
                        zip(tok, tok[1:])]
            ref = solo[i] if i < 2 else served.generate(
                np.asarray([sse_prompts[i]], np.int32),
                max_new_tokens=DEC_NEW)[0].tolist()
            sse_div.append(first_divergence([t for t, _ in tok],
                                            ref[len(sse_prompts[i]):]))
        phase("decoder generate SSE", sse_ok and midflight,
              f"{DEC_SSE} streams (2 admitted while 2 were mid-flight: "
              f"{midflight}), each open, {DEC_NEW} tokens, done; first "
              f"divergence from a solo generate {sse_div} (None: equal)")

        # Abort: one stream DELETEd after its 5th token.
        stream_id, got_ids, deleted = [None], [], {}

        def on_token(doc, n):
            if n == DEC_ABORT_AFTER and not deleted:
                dec = server.serving.decode._decoders[DEC_MODEL]
                sid = next(iter(dec._streams))
                stream = dec._streams[sid]
                stream_id[0] = sid
                deleted["status"], _ = request(
                    port, "DELETE", f"/serve/{DEC_MODEL}/generate/{sid}")
                deleted["tokens_at_cancel"] = len(stream.tokens)
                deleted["stream"] = stream

        status, events = read_sse(port, {"prompts": [prompts[2]],
                                         "stream": True,
                                         "maxNewTokens": DEC_NEW},
                                  on_token=on_token)
        stream = deleted.get("stream")
        after = (len(stream.tokens) - deleted["tokens_at_cancel"]
                 if stream else None)
        st = server.serving.decode.stats()["models"][DEC_MODEL]
        status2, _ = request(port, "DELETE",
                             f"/serve/{DEC_MODEL}/generate/{stream_id[0]}")
        names = [n for n, _, _ in events]
        phase("decoder abort", deleted.get("status") == 200
              and names[-1:] == ["aborted"] and after is not None
              and after <= 1 and st["activeStreams"] == 0
              and all(p["live"] == 0 for p in st["pools"])
              and status2 == 404,
              f"DELETE after token {DEC_ABORT_AFTER} -> "
              f"{deleted.get('status')}; stream ended with {names[-1:]}; "
              f"tokens emitted after the cancel {after} (<= 1: the slot "
              f"freed at the next step boundary); live slots "
              f"{[p['live'] for p in st['pools']]}; second DELETE -> "
              f"{status2}")

        # One sampled request: the solo path.
        status, body = request(port, "POST", f"/serve/{DEC_MODEL}/generate",
                               {"prompts": [prompts[0]], "maxNewTokens": 32,
                                "temperature": 0.8, "topK": 40, "seed": 3})
        new = (body.get("newTokens") or [[]])[0]
        phase("decoder sampled generate", status == 200
              and body.get("sampled") is True and len(new) == 32
              and all(0 < t < GPT2["vocab_size"] for t in new),
              f"temperature 0.8, topK 40 -> {status}, {len(new)} tokens in "
              "(0, 50257)")

        st = server.serving.decode.stats()["models"][DEC_MODEL]
        line["pools"] = st["pools"]
        line["graphs"] = st["graphs"]
        # Each cell's step is timed in phase 15, graph against eager.
        warm = dict(server.serving.registry.get(DEC_MODEL).decode_warm)
        line["throughput"] = decoder_throughput(
            server, served, [p[:DEC_PROMPT_LENS[0]] for p in prompts])
        line["ttft_ms"] = {"p50": float(np.median(ttft)),
                           "max": float(np.max(ttft))}
        line["itl_ms"] = {"p50": float(np.median(itl)),
                          "p99": float(np.percentile(itl, 99))}
    finally:
        server.shutdown()

    # (d) the cache against the model, on the trained f32 masters.
    zero_kernel_counts()
    line["cache_vs_forward"] = step_logits_check(
        est, [prompts[0], prompts[1]], DEC_NEW, "GPT-2 learned")
    launches["forward_f32"] = kernel_counts()
    del est
    torch.cuda.empty_cache()

    # (e) rope + GQA + window at 2 layers, untrained.
    rope = DecoderLM(**GPT2_ROPE, seed=1, device=DEC_DEVICE)
    zero_kernel_counts()
    line["cache_vs_forward_rope"] = step_logits_check(
        rope, [decoder_rows(1, GPT2_ROPE["attention_window"] + 44,
                            seed=7)[0].tolist(),
               decoder_rows(1, 40, seed=8)[0].tolist()], 24,
        "rope + GQA 12/4 + window 256, 2 layers")
    launches["forward_f32_rope"] = kernel_counts()
    del rope
    torch.cuda.empty_cache()

    line["launches"] = launches
    line["phase_s"] = time.perf_counter() - t_phase
    name, _, limit = card.partition(",")
    line = {"card": name.strip(), "power_limit": limit.strip(), **line}
    return {"line": line, "launches": launches, "artifact": artifact,
            "prompts": prompts, "solo": solo, "warm": warm}


# -- phase 14: fleet serving (replica sets, the P2C router, the autoscaler) --

FLEET_MODEL = "bert-base"
FLEET_DEVICE = "cuda"
FLEET_CLIENTS = 16  # client threads of the drill and of each A/B window
FLEET_ROWS = 8  # rows of every drill / window request, T = SEQ_LEN
FLEET_WINDOW = 6  # requests per client in each A/B window
FLEET_TICK_S = 0.1  # the autoscaler's interval
FLEET_LEASE_S = 2.0  # FleetConfig.lease_timeout_s
FLEET_WAIT_S = 30.0  # deadline of each move the phase waits for
FLEET_ABORT_AFTER = 5


def fleet_config(tmp):
    """Phase 8's server config with the fleet knobs of the phase: both
    models resident at once, a fast autoscaler, replica pre-warm on."""
    cfg = server_config(tmp)
    cfg.serve.max_bytes = 4 << 30
    cfg.fleet.interval_s = FLEET_TICK_S
    cfg.fleet.up_queue_frac = 0.1
    cfg.fleet.up_ticks = 2
    cfg.fleet.down_ticks = 3
    cfg.fleet.lease_timeout_s = FLEET_LEASE_S
    cfg.aot.replica_prewarm = True
    return cfg


def request_h(port, verb, path, body=None):
    """(status, headers, JSON body) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(verb, "/api/learningOrchestra/v1" + path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def write_fleet_csv(path) -> None:
    """64 rows of 4 seeded features and a label: the small train job."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((64, 4))
    with open(path, "w") as fh:
        fh.write("f0,f1,f2,f3,label\n")
        for row in x:
            fh.write(",".join(f"{v:.6f}" for v in row)
                     + f",{int(row[0] > 0)}\n")


def fleet_batch(vocab: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    x = rng.integers(1, vocab, (FLEET_ROWS, SEQ_LEN)).astype(np.int32)
    for r in range(FLEET_ROWS):
        x[r, int(rng.integers(16, SEQ_LEN + 1)):] = 0  # pad tail
    return x.tolist()


def fleet_load(port, body, n=None, stop=None) -> tuple:
    """``FLEET_CLIENTS`` threads each sending ``n`` predicts of ``body``
    (or until ``stop`` is set): [(status, latency s, replica)], wall s."""
    results, lock = [], threading.Lock()

    def client():
        k = 0
        while (n is None or k < n) and not (stop and stop.is_set()):
            t0 = time.perf_counter()
            status, doc = request(port, "POST",
                                  f"/serve/{FLEET_MODEL}/predict", body)
            with lock:
                results.append((status, time.perf_counter() - t0,
                                doc.get("replica")))
            k += 1
            if status == 429:
                time.sleep(0.01)

    threads = [threading.Thread(target=client) for _ in range(FLEET_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return results, time.perf_counter() - t0


def window_stats(results, wall: float) -> dict:
    ok = [r for r in results if r[0] == 200]
    lat = sorted(r[1] * 1e3 for r in ok) or [float("nan")]
    per: dict = {}
    for r in ok:
        per[str(r[2])] = per.get(str(r[2]), 0) + 1
    return {"requests": len(results), "ok": len(ok),
            "status_429": sum(r[0] == 429 for r in results),
            "rows_per_s": len(ok) * FLEET_ROWS / wall, "wall_s": wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "requests_per_replica": dict(sorted(per.items()))}


def _poll_until(cond, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def run_fleet(tmp, card: str, bert_artifact, dec_artifact) -> dict:
    """Phase 14: fleet serving through the REST entry points on one card.
    (a) the real one-card pool: the cutover onto one replica holding
    ``cuda:0``, 24 concurrent requests through it against the single
    path, a second replica refused 503 while serving goes on, a REST train
    job waiting for the card until the fleet is dissolved; (b) two lease
    units on the one card (``ctx.leaser`` replaced, the JAX fleet tests'
    seam): the autoscaler scales 1 -> 2 -> 1 under 16 clients, then the
    same burst at 1 and at 2 replicas; (c) the DecoderLM's streams over
    two replicas against solo decodes, an abort, pre-warm of the decode
    steps."""
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.jobs.leases import DeviceLeaser
    from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE
    from learningorchestra_tpu_torch.store.volumes import VolumeStorage

    t_phase = time.perf_counter()
    line: dict = {}
    launches: dict = {}
    volumes = VolumeStorage(tmp)
    volumes.save_object(ARTIFACT_TYPE, FLEET_MODEL, bert_artifact)
    volumes.save_object(ARTIFACT_TYPE, DEC_MODEL, dec_artifact)
    csv = f"{tmp}/fleet_rows.csv"
    write_fleet_csv(csv)
    server = APIServer(fleet_config(tmp), device=FLEET_DEVICE)
    port = server.start_background()
    serving = server.serving
    # Each pre-warm's buckets, decode steps and seconds, observed by
    # wrapping the service's warm-up binder.
    warm_log: list = []
    real_factory = serving.replica_warmup_factory

    def timed_factory(name):
        warm = real_factory(name)
        if warm is None:
            return None

        def timed(replica):
            entry = serving.registry.peek(name)
            rec = {"model": name, "replica": replica.idx,
                   "buckets": len(entry.warm_shapes) if entry else 0,
                   "decode_steps": len(entry.decode_warm) if entry else 0}
            t0 = time.perf_counter()
            warm(replica)
            torch.cuda.synchronize()
            rec["s"] = time.perf_counter() - t0
            warm_log.append(rec)

        return timed

    serving.replica_warmup_factory = timed_factory

    def replicas_doc(name):
        return request(port, "GET", f"/serve/{name}/replicas")[1]

    try:
        # Jobs that lease the card themselves go first, before any replica
        # holds it: the dataset, its projection and the model binary.
        setup = []
        for path, body, name in (
                ("/dataset/csv", {"datasetName": "fl_rows",
                                  "url": f"file://{csv}"}, "fl_rows"),
                ("/transform/projection",
                 {"projectionName": "fl_x", "datasetName": "fl_rows",
                  "fields": ["f0", "f1", "f2", "f3"]}, "fl_x"),
                ("/model/tensorflow",
                 {"modelName": "fl_mlp", "class": "MLPClassifier",
                  "modulePath": "learningorchestra_tpu.models.mlp",
                  "classParameters": {"hidden_layer_sizes": [8],
                                      "num_classes": 2}}, "fl_mlp")):
            status, meta, _, _ = rest_job(port, "POST", path, body, name)
            setup.append((name, status, meta.get("jobState")))

        # (a) the one-card pool as the context built it.
        reqs = make_requests(30522)
        zero_kernel_counts()
        status, _ = request(port, "POST", f"/serve/{FLEET_MODEL}/load")
        launches["fleet_bert_load"] = kernel_counts()
        with concurrent.futures.ThreadPoolExecutor(N_REQUESTS) as pool:
            single = list(pool.map(
                lambda x: request(port, "POST",
                                  f"/serve/{FLEET_MODEL}/predict",
                                  {"instances": x.tolist()}), reqs))
        phase("fleet single path", status == 200
              and all(s == 200 for s, _ in single)
              and all(st == 201 and js == "finished"
                      for _, st, js in setup)
              and launches["fleet_bert_load"]["dequantize_rowwise"] == 1,
              f"setup jobs {setup}; load -> {status} (K5 "
              f"{launches['fleet_bert_load']['dequantize_rowwise']} launch);"
              f" {N_REQUESTS} requests on the single path -> "
              f"{sorted({s for s, _ in single})}")
        zero_kernel_counts()
        t0 = time.perf_counter()
        status, doc = request(port, "POST", f"/serve/{FLEET_MODEL}/replicas",
                              {"min": 1, "max": 2})
        line["cutover_s"] = time.perf_counter() - t0
        launches["fleet_cutover"] = kernel_counts()
        free = server.ctx.leaser.snapshot()["free"]
        reps = doc.get("replicas") or [{}]
        phase("fleet cutover (one-card pool)", status == 200
              and doc.get("size") == 1 and reps[0].get("device") == "cuda:0"
              and free == []
              and launches["fleet_cutover"]["dequantize_rowwise"] == 0,
              f"POST /serve/{FLEET_MODEL}/replicas {{min 1, max 2}} -> "
              f"{status} in {line['cutover_s']:.3f}s: size "
              f"{doc.get('size')}, device {reps[0].get('device')}, free "
              f"lease units {free} (the replica holds the card); K5 "
              f"{launches['fleet_cutover']['dequantize_rowwise']} launches "
              f"(0: the replica shares the resident module); pre-warm "
              f"{warm_log}")
        batches0 = sum(r["batches"] for r in replicas_doc(FLEET_MODEL)
                       ["replicas"])
        zero_kernel_counts()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(N_REQUESTS) as pool:
            routed = list(pool.map(
                lambda x: request(port, "POST",
                                  f"/serve/{FLEET_MODEL}/predict",
                                  {"instances": x.tolist()}), reqs))
        wall = time.perf_counter() - t0
        launches["fleet_predict_one_card"] = kernel_counts()
        dispatches = sum(r["batches"] for r in replicas_doc(FLEET_MODEL)
                         ["replicas"]) - batches0
        err = max(float(np.abs(np.asarray(b.get("predictions", np.nan))
                               - np.asarray(s["predictions"])).max())
                  for (_, b), (_, s) in zip(routed, single))
        k1 = launches["fleet_predict_one_card"]["flash_fwd"]
        phase("fleet predict (one-card pool)",
              all(st == 200 and b.get("replica") == 0
                  and b.get("device") == "cuda:0" for st, b in routed)
              and err <= CPU_ATOL and k1 == 12 * dispatches,
              f"{N_REQUESTS} concurrent requests -> statuses "
              f"{sorted({s for s, _ in routed})}, replicas "
              f"{sorted({b.get('replica') for _, b in routed}, key=str)} in "
              f"{wall:.3f}s; max|fleet - single path| = {err:.3g} (bar "
              f"{CPU_ATOL}); K1 {k1} launches = 12 x {dispatches} "
              "dispatches")
        line["one_card"] = {"requests": N_REQUESTS, "wall_s": wall,
                            "dispatches": dispatches,
                            "max_abs_vs_single_path": err}

        # A train job submitted while the replica holds the card, then a
        # second replica: 503 within the lease budget, serving goes on.
        t_train = time.perf_counter()
        st_train, _ = request(port, "POST", "/train/tensorflow", {
            "name": "fl_fit", "parentName": "fl_mlp", "method": "fit",
            "methodParameters": {"x": "$fl_x", "y": "$fl_rows.label",
                                 "epochs": 2, "batch_size": 16}})
        stop, during = threading.Event(), []

        def keep_predicting():
            while not stop.is_set():
                during.append(request(
                    port, "POST", f"/serve/{FLEET_MODEL}/predict",
                    {"instances": reqs[0].tolist()})[0])

        keeper = threading.Thread(target=keep_predicting)
        keeper.start()
        t0 = time.perf_counter()
        st503, hdrs, _ = request_h(
            port, "POST", f"/serve/{FLEET_MODEL}/replicas", {"count": 2})
        wait503 = time.perf_counter() - t0
        stop.set()
        keeper.join()
        _, polled = request(port, "GET", "/observe/fl_fit?timeout=0")
        waiting = polled.get("metadata", polled)
        free_held = server.ctx.leaser.snapshot()["free"]
        t0 = time.perf_counter()
        st_del, dissolved = request(port, "DELETE",
                                    f"/serve/{FLEET_MODEL}/replicas")
        line["dissolve_s"] = time.perf_counter() - t0
        trained = wait_done(port, "fl_fit")
        line["train_job_s"] = time.perf_counter() - t_train
        free_after = server.ctx.leaser.snapshot()["free"]
        line["status_503"] = int(st503 == 503)
        line["wait_503_s"] = wait503
        phase("fleet lease hand-off (one-card pool)",
              st_train == 201 and st503 == 503
              and "Retry-After" in hdrs and wait503 <= 2 * FLEET_LEASE_S + 1
              and bool(during) and all(s == 200 for s in during)
              and not waiting.get("finished") and free_held == []
              and st_del == 200 and dissolved.get("dissolved") is True
              and trained.get("jobState") == "finished"
              and free_after == ["cuda:0"],
              f"train POST -> {st_train}; count 2 -> {st503} "
              f"(Retry-After {hdrs.get('Retry-After')}) after "
              f"{wait503:.2f}s (lease budget {FLEET_LEASE_S}s); "
              f"{len(during)} predicts meanwhile -> {sorted(set(during))}; "
              f"the train job then: finished {waiting.get('finished')}, "
              f"free units {free_held}; DELETE -> {st_del} "
              f"{dissolved} in {line['dissolve_s']:.2f}s; the job "
              f"{trained.get('jobState')} {line['train_job_s']:.2f}s after "
              f"its POST; free units {free_after}")

        # (b) two lease units on the one card.
        server.ctx.leaser = DeviceLeaser(["cuda:0", "cuda:0"])
        print("[info] fleet (b): ctx.leaser replaced by DeviceLeaser("
              "['cuda:0', 'cuda:0']), two lease units on the one card "
              "(the seam the JAX fleet tests use; no config knob)",
              flush=True)
        zero_kernel_counts()
        n_warm = len(warm_log)
        body = {"instances": fleet_batch(30522, 1)}
        status, doc = request(port, "POST", f"/serve/{FLEET_MODEL}/replicas",
                              {"min": 1, "max": 2})
        results, stop = [], threading.Event()
        t_load = time.time()
        loader = threading.Thread(target=lambda: results.extend(
            fleet_load(port, body, stop=stop)[0]))
        loader.start()
        reached = _poll_until(lambda: any(
            r["replica"] == 1 and r["requests"] > 0
            for r in replicas_doc(FLEET_MODEL)["replicas"]), FLEET_WAIT_S)
        stop.set()
        loader.join()
        t_stop = time.perf_counter()
        drained = _poll_until(lambda: replicas_doc(FLEET_MODEL)["size"] == 1
                              and len(server.ctx.leaser.snapshot()["free"])
                              == 1, FLEET_WAIT_S)
        line["drain_wait_s"] = time.perf_counter() - t_stop
        auto = request(port, "GET", "/serve/fleet")[1]["autoscaler"]
        ledger = [r for r in auto["ledger"]
                  if r["model"] == FLEET_MODEL and r["t"] >= t_load]
        downs = [r for r in ledger if r["action"] == "down"]
        decisions = [d for d in auto["decisions"]
                     if d["model"] == FLEET_MODEL and d["t"] >= t_load]
        dec_up = next((d for d in decisions if d["to"] > d["from"]), None)
        dec_down = next((d for d in decisions if d["to"] < d["from"]), None)
        pressured = next((r for r in ledger if r["upStreak"] >= 1), None)
        if dec_up and pressured:
            line["scale_up_s"] = dec_up["t"] - pressured["t"]
        if dec_down and downs:
            line["scale_down_drain_s"] = dec_down["t"] - downs[0]["t"]
        warm_b = [w for w in warm_log[n_warm:] if w["model"] == FLEET_MODEL]
        line["scale_up_warmup"] = warm_b
        drill = window_stats(results, 1.0)
        bad = [r[0] for r in results if r[0] not in (200, 429)]
        line["drill"] = {"requests": len(results),
                         "status_429": drill["status_429"],
                         "requests_per_replica":
                             drill["requests_per_replica"],
                         "up": dec_up, "down": dec_down}
        phase("fleet autoscale drill (two units)", status == 200
              and reached and drained and dec_up is not None
              and dec_down is not None and not bad
              and any(w["replica"] == 1 for w in warm_b),
              f"{FLEET_CLIENTS} clients of {FLEET_ROWS}-row T={SEQ_LEN} "
              f"requests: replica 1 served: {reached}; scale-up "
              f"{line.get('scale_up_s')}s from the first pressured tick "
              f"({dec_up and dec_up['signal']}), pre-warm {warm_b}; after "
              f"the load stopped, back to 1 with a unit free: {drained} "
              f"({line['drain_wait_s']:.2f}s; the drain itself "
              f"{line.get('scale_down_drain_s')}s); {len(results)} "
              f"requests, {drill['status_429']} answered 429, others "
              f"failed {len(bad)}; per replica "
              f"{drill['requests_per_replica']}")

        windows = {}
        for n in (1, 2):
            request(port, "POST", f"/serve/{FLEET_MODEL}/replicas",
                    {"min": n, "max": n})
            res, wall = fleet_load(port, body, n=FLEET_WINDOW)
            windows[n] = window_stats(res, wall)
        line["windows"] = {f"replicas_{n}": w for n, w in windows.items()}
        line["ratio_2_over_1"] = (windows[2]["rows_per_s"]
                                  / windows[1]["rows_per_s"])
        merged = serving.stats()["models"][FLEET_MODEL]
        counts = kernel_counts()
        launches["fleet_predict_two_units"] = counts
        warm_dispatches = sum(w["buckets"] for w in warm_log[n_warm:]
                              if w["model"] == FLEET_MODEL)
        want = 12 * (merged["batches"] + warm_dispatches)
        phase("fleet manual A/B and K1 launches (two units)",
              all(w["ok"] == FLEET_CLIENTS * FLEET_WINDOW
                  for w in windows.values())
              and set(windows[2]["requests_per_replica"]) == {"0", "1"}
              and counts["flash_fwd"] == want,
              f"1 replica {windows[1]['rows_per_s']:.1f} rows/s, 2 replicas "
              f"{windows[2]['rows_per_s']:.1f} rows/s (ratio "
              f"{line['ratio_2_over_1']:.3f}), per replica "
              f"{windows[2]['requests_per_replica']}; K1 over (b) "
              f"{counts['flash_fwd']} = 12 x ({merged['batches']} "
              f"dispatches + {warm_dispatches} pre-warm) = {want}")
        request(port, "DELETE", f"/serve/{FLEET_MODEL}/replicas")

        # (c) the decoder's streams over two replicas.
        zero_kernel_counts()
        status, _ = request(port, "POST", f"/serve/{DEC_MODEL}/load")
        launches["fleet_decoder_load"] = kernel_counts()
        request(port, "POST", f"/serve/{DEC_MODEL}/replicas",
                {"min": 1, "max": 1})
        prompts = decoder_prompts()
        request(port, "POST", f"/serve/{DEC_MODEL}/generate",
                {"prompts": [prompts[0]], "maxNewTokens": 8})
        n_warm = len(warm_log)
        st_up, doc = request(port, "POST", f"/serve/{DEC_MODEL}/replicas",
                             {"min": 2, "max": 2})
        warm_d = warm_log[n_warm:]
        # Which replica's pool each stream was seated in, observed by
        # wrapping the decoder's admission (on its worker thread).
        decoder = serving.decode._decoder_for(DEC_MODEL)
        routed_to: list = []
        real_admit = decoder._admit

        def admit(stream):
            seated = real_admit(stream)
            routed_to.extend(key[0] for key, p in decoder._pools.items()
                             if seated and stream in p.streams)
            return seated

        decoder._admit = admit
        t0 = time.perf_counter()
        st_json, out = request(port, "POST", f"/serve/{DEC_MODEL}/generate",
                               {"prompts": prompts, "maxNewTokens": DEC_NEW})
        json_s = time.perf_counter() - t0
        served = serving.registry.get(DEC_MODEL).estimator
        solo = [served.generate(np.asarray([p], np.int32),
                                max_new_tokens=DEC_NEW)[0].tolist()
                for p in prompts]
        toks = out.get("tokens", [])
        results = [None, None]

        def sse(i):
            results[i] = read_sse(port, {"prompts": [prompts[i]],
                                         "stream": True,
                                         "maxNewTokens": DEC_NEW})

        threads = [threading.Thread(target=sse, args=(i,)) for i in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        sse_ok = all(
            res is not None and res[0] == 200
            and prompts[i] + [d["t"] for n, d, _ in res[1] if n == "token"]
            == solo[i] for i, res in enumerate(results))
        aborted = {}

        def on_token(doc, n):
            if n == FLEET_ABORT_AFTER and not aborted:
                sid = next(iter(decoder._streams))
                key = next(k for k, p in list(decoder._pools.items())
                           for s in p.streams
                           if s is not None and s.stream_id == sid)
                aborted["replica"] = key[0]
                aborted["status"] = request(
                    port, "DELETE", f"/serve/{DEC_MODEL}/generate/{sid}")[0]

        _, events = read_sse(port, {"prompts": [prompts[2]], "stream": True,
                                    "maxNewTokens": DEC_NEW},
                             on_token=on_token)
        pools = serving.decode.stats()["models"][DEC_MODEL]["pools"]
        freed = [p["live"] for p in pools
                 if p["replica"] == aborted.get("replica")]
        per_replica = {str(k): routed_to.count(k) for k in sorted(
            set(routed_to), key=str)}
        line["decode"] = {
            "streams_per_replica": per_replica,
            "json_s": json_s,
            "tokens_per_s": len(prompts) * DEC_NEW / json_s,
            "scale_up_warmup": warm_d,
            "pools": pools}
        phase("fleet decode through two replicas",
              status == 200 and st_up == 200 and doc.get("size") == 2
              and st_json == 200 and toks == solo and sse_ok
              and set(per_replica) == {"0", "1"}
              and any(w["replica"] == 1 and w["decode_steps"] >= 1
                      for w in warm_d)
              and aborted.get("status") == 200
              and [n for n, _, _ in events][-1:] == ["aborted"]
              and bool(freed) and all(v == 0 for v in freed)
              and launches["fleet_decoder_load"]["dequantize_rowwise"] == 1,
              f"load K5 {launches['fleet_decoder_load']['dequantize_rowwise']}"
              f" launch; {{min 2, max 2}} -> {st_up}, size {doc.get('size')},"
              f" pre-warm {warm_d}; {len(prompts)} prompts x {DEC_NEW} new "
              f"-> {st_json} in {json_s:.2f}s, streams per replica "
              f"{per_replica}, equal to solo decodes: {toks == solo}; 2 SSE "
              f"streams equal to solo: {sse_ok}; abort after token "
              f"{FLEET_ABORT_AFTER} on replica {aborted.get('replica')} -> "
              f"{aborted.get('status')}, ended "
              f"{[n for n, _, _ in events][-1:]}, that replica's live slots "
              f"{freed}")
        request(port, "DELETE", f"/serve/{DEC_MODEL}/replicas")
        line["free_units_at_end"] = len(server.ctx.leaser.snapshot()["free"])
    finally:
        server.shutdown()
    launches["fleet_predict"] = {"flash_fwd": sum(
        launches.get(k, {}).get("flash_fwd", 0)
        for k in ("fleet_cutover", "fleet_predict_one_card",
                  "fleet_predict_two_units"))}
    launches["fleet_load"] = {"dequantize_rowwise": sum(
        launches.get(k, {}).get("dequantize_rowwise", 0)
        for k in ("fleet_bert_load", "fleet_cutover",
                  "fleet_predict_one_card", "fleet_predict_two_units",
                  "fleet_decoder_load"))}
    line["launches"] = launches
    line["phase_s"] = time.perf_counter() - t_phase
    name, _, limit = card.partition(",")
    line = {"card": name.strip(), "power_limit": limit.strip(), **line}
    return {"line": line, "launches": launches}


# -- phase 15: the program cache and the cost plane ---------------------------

# The card's dense bf16 peak (NVIDIA H100 SXM data sheet): the cost plane's
# LO_TPU_COSTS_PEAK_FLOPS for this run, so MFU is reported.
COSTS_PEAK_FLOPS = 989.4e12
PC_TUNE_SEEDS = [1, 2]  # a 2-candidate grid over one architecture
# The train job's FLOPs per step (FlopCounterMode over one real epoch,
# K1-K3 by formula) against the analytic BERT-base count at (32, 128).
PC_FLOPS_BAR = 1e-2
PC_SERVE_REQUESTS = 4
PC_SSE = 2


def bert_step_flops(batch: int, t: int, hidden=768, layers=12, heads=12,
                    mlp=3072, classes=2) -> float:
    """Analytic FLOPs of one BERT-base fine-tune step: every GEMM of the
    forward (QKV, output, MLP per layer over all tokens; the pooler and
    the classifier over the [CLS] rows) three times (forward, input
    gradient, weight gradient), plus K1, K2 and K3 at 4, 6 and 8 FLOPs
    per (query, key) pair and head dimension."""
    tokens = batch * t
    per_layer = hidden * 3 * hidden + hidden * hidden + 2 * hidden * mlp
    gemm = 2 * tokens * per_layer * layers + 2 * batch * (
        hidden * hidden + hidden * classes)
    attention = (4 + 6 + 8) * batch * heads * t * t * (hidden // heads) \
        * layers
    return 3 * gemm + attention


def run_program_cache(tmp, card: str, dec: dict) -> dict:
    """Phase 15 on the card: (a) the same BERT-base train spec twice over
    REST (the second job resolves every program from the cache), a
    2-candidate tune of one architecture, ``GET /monitoring/tensorflow/
    compileCache``; (b) the train job's ``deviceTime`` (device s, FLOPs,
    MFU against COSTS_PEAK_FLOPS) and its FLOPs per step against the
    analytic count, the cost plane's per-model and per-bucket view after
    fresh serving requests; (c) phase 13's DecoderLM served from its int8
    artifact: ``/generate`` of 8 prompts and 2 SSE streams through the
    step programs' CUDA graphs, held to phase 13's solo decodes token for
    token, and each (S, Tk) cell's graph step against the eager step."""
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.obs import costs
    from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE
    from learningorchestra_tpu_torch.store.volumes import VolumeStorage
    from learningorchestra_tpu_torch.train import compile_cache

    t_phase = time.perf_counter()
    # A cold start, as a fresh process has (before the server, whose
    # context listens on the cache): earlier phases' programs and FLOP
    # analyses go, so job 1 builds and analyzes what job 2 then resolves.
    compile_cache.reset_cache()
    costs.reset()
    csv = f"{tmp}/tokens.csv"
    x, _ = write_token_csv(csv)
    server = APIServer(server_config(f"{tmp}/volumes"), device="cuda")
    port = server.start_background()
    jobs, line, launches = {}, {}, {}

    def run(key, verb, path, body, name):
        status, meta, secs, counts = rest_job(port, verb, path, body, name)
        good = status in (200, 201) and meta.get("jobState") == "finished"
        jobs[key] = {"seconds": secs, "launches": counts, "meta": meta}
        phase(f"program cache job {key}", good,
              f"{verb} {path} -> {status}, jobState {meta.get('jobState')} "
              f"in {secs:.2f}s; launches {counts}"
              + ("" if good else f"; metadata {meta}"))
        return meta

    steps = TRAIN_EPOCHS * -(-TRAIN_ROWS // TRAIN_SHAPE[0])
    fit_params = {"x": "$tokens_x", "y": "$tokens.label",
                  "epochs": TRAIN_EPOCHS, "batch_size": TRAIN_SHAPE[0],
                  "shuffle": False, "quantize_checkpoint": True}
    try:
        run("ingest", "POST", "/dataset/csv",
            {"datasetName": "tokens", "url": f"file://{csv}"}, "tokens")
        run("projection", "POST", "/transform/projection",
            {"projectionName": "tokens_x", "datasetName": "tokens",
             "fields": REST_FIELDS}, "tokens_x")
        run("model", "POST", "/model/tensorflow",
            {"modelName": "bert", "class": "BertModel",
             "modulePath": "learningorchestra_tpu.models.text",
             "classParameters": REST_MODEL}, "bert")
        # (a) the same spec twice.
        per_job = {"flash_fwd": REST_LAYERS * steps,
                   "flash_bwd_dq": REST_LAYERS * steps,
                   "flash_bwd_dkv": REST_LAYERS * steps,
                   "quantize_rowwise": 1, "dequantize_rowwise": 0}
        # A hit skips the program's build and its first call's FLOP
        # analysis (the ledger's count of analyses); the programs are
        # eager, so the build itself costs next to nothing.
        metas, analyses = [], []
        for key in ("pc_fit1", "pc_fit2"):
            before = costs.get_ledger().snapshot()
            metas.append(run(key, "POST", "/train/tensorflow",
                             {"name": key, "parentName": "bert",
                              "method": "fit",
                              "methodParameters": fit_params}, key))
            after = costs.get_ledger().snapshot()
            analyses.append(after["analyses"] - before["analyses"])
        caches = [m.get("compileCache", {}) for m in metas]
        job_s = [jobs[k]["seconds"] for k in ("pc_fit1", "pc_fit2")]
        launches["train"] = [jobs[k]["launches"]
                             for k in ("pc_fit1", "pc_fit2")]
        phase("program cache second identical job",
              caches[0].get("misses", 0) >= 1 and analyses[0] >= 1
              and caches[1].get("misses") == 0
              and caches[1].get("hits", 0) >= 1 and analyses[1] == 0
              and all(c == per_job for c in launches["train"]),
              f"from a cold cache: compileCache job 1 {caches[0]}, job 2 "
              f"{caches[1]} (want misses >= 1, then misses 0, hits >= 1); "
              f"FLOP analyses {analyses} (want >= 1, then 0); seconds "
              f"{job_s}; launches {launches['train']} (want {per_job} "
              f"each)")
        tune = run("tune", "POST", "/tune/tensorflow", {
            "name": "pc_tune", "parentName": "bert", "method": "fit",
            "paramGrid": {"seed": PC_TUNE_SEEDS,
                          **{k: [v] for k, v in REST_MODEL.items()}},
            "methodParameters": fit_params}, "pc_tune")
        score_batches = -(-TRAIN_ROWS // 128)
        n = len(PC_TUNE_SEEDS)
        want_tune = {"flash_fwd": REST_LAYERS * (steps + score_batches) * n,
                     "flash_bwd_dq": REST_LAYERS * steps * n,
                     "flash_bwd_dkv": REST_LAYERS * steps * n,
                     "quantize_rowwise": 1, "dequantize_rowwise": 0}
        launches["tune"] = jobs["tune"]["launches"]
        tcache = tune.get("compileCache", {})
        phase("program cache tune", launches["tune"] == want_tune
              and tcache.get("misses") == 0
              and tcache.get("hits") == 2 * n,
              f"{n} candidates of one architecture: compileCache {tcache} "
              f"(want misses 0: both programs built by the train jobs, "
              f"hits {2 * n}: epoch_fns and device_epoch per candidate); "
              f"launches {launches['tune']} (want {want_tune})")
        status, cache_doc = request(
            port, "GET", "/monitoring/tensorflow/compileCache")
        phase("program cache monitoring", status == 200
              and {"hits", "misses", "programs", "programCosts", "aot"}
              <= set(cache_doc),
              f"GET /monitoring/tensorflow/compileCache -> {status}: "
              f"entries {cache_doc.get('entries')}, hits "
              f"{cache_doc.get('hits')}, misses {cache_doc.get('misses')}, "
              f"programs {cache_doc.get('programs')}")
        line["compile_cache"] = {"train_jobs": caches, "tune": tcache,
                                 "train_job_s": job_s,
                                 "train_job_analyses": analyses,
                                 "monitoring": {k: cache_doc.get(k) for k in (
                                     "entries", "hits", "misses",
                                     "coalesced", "evictions",
                                     "traceTimeS")}}

        # (b) device time, FLOPs and MFU of the train jobs.
        dts = [m.get("deviceTime") or {} for m in metas]
        flops_step = [d.get("flops", 0) / steps for d in dts]
        analytic = bert_step_flops(TRAIN_SHAPE[0], TRAIN_SHAPE[2])
        rel = [abs(f - analytic) / analytic for f in flops_step]
        mfu = [d.get("mfu") for d in dts]
        phase("program cache deviceTime",
              all(d.get("dispatches") == TRAIN_EPOCHS for d in dts)
              and all(r <= PC_FLOPS_BAR for r in rel)
              and all(m is not None and 0 < m <= 1 for m in mfu),
              f"train jobs: device s {[d.get('deviceTimeS') for d in dts]}, "
              f"FLOPs {[d.get('flops') for d in dts]}, MFU {mfu} (peak "
              f"{COSTS_PEAK_FLOPS:.4g} FLOP/s); FLOPs per step "
              f"{flops_step} vs analytic {analytic:.6g} at (32, 128): "
              f"relative {rel} (bar {PC_FLOPS_BAR})")
        line["device_time"] = {"train_jobs": dts, "tune": tune.get(
            "deviceTime"), "flops_per_step": flops_step,
            "analytic_flops_per_step": analytic, "relative_error": rel,
            "peak_flops": COSTS_PEAK_FLOPS}
        # Fresh serving requests of the trained artifact (K5 at the load).
        zero_kernel_counts()
        served_ok = True
        for i in range(PC_SERVE_REQUESTS):
            status, body = request(port, "POST", "/serve/pc_fit2/predict",
                                   {"instances": x[8 * i:8 * i + 8].tolist()})
            served_ok &= status == 200 and len(body.get(
                "predictions", [])) == 8
        launches["serve"] = kernel_counts()
        status, cost_doc = request(port, "GET", "/observability/costs")
        models = cost_doc.get("deviceTime", {}).get("models", {})
        buckets = cost_doc.get("deviceTime", {}).get("buckets", {})
        phase("program cache serving costs", status == 200 and served_ok
              and "pc_fit2" in models and "pc_fit2:8" in buckets
              and launches["serve"]["dequantize_rowwise"] == 1
              and launches["serve"]["flash_fwd"] == 12 * PC_SERVE_REQUESTS,
              f"{PC_SERVE_REQUESTS} predicts of 8 rows -> {served_ok}, "
              f"launches {launches['serve']} (want K5 1, K1 12 x "
              f"{PC_SERVE_REQUESTS}); GET /observability/costs -> {status}")
        print("costs_by_model " + json.dumps(models), flush=True)
        print("costs_by_bucket " + json.dumps(buckets), flush=True)
        line["costs_by_model"] = models
        line["costs_by_bucket"] = buckets
    finally:
        server.shutdown()

    # (c) the decode step as a CUDA graph, on phase 13's int8 artifact.
    volumes = VolumeStorage(f"{tmp}/dec")
    volumes.save_object(ARTIFACT_TYPE, DEC_MODEL, dec["artifact"])
    server = APIServer(server_config(f"{tmp}/dec"), device=DEC_DEVICE)
    port = server.start_background()
    try:
        prompts, solo = dec["prompts"], dec["solo"]
        zero_kernel_counts()
        status, _ = request(port, "POST", f"/serve/{DEC_MODEL}/load")
        launches["decoder_load"] = kernel_counts()
        served = server.serving.registry.get(DEC_MODEL).estimator
        zero_kernel_counts()
        t0 = time.perf_counter()
        status, body = request(port, "POST", f"/serve/{DEC_MODEL}/generate",
                               {"prompts": prompts, "maxNewTokens": DEC_NEW})
        json_s = time.perf_counter() - t0
        launches["generate"] = kernel_counts()
        toks = body.get("tokens", [])
        results = [None] * PC_SSE

        def sse(i):
            results[i] = read_sse(port, {"prompts": [prompts[i]],
                                         "stream": True,
                                         "maxNewTokens": DEC_NEW})

        threads = [threading.Thread(target=sse, args=(i,))
                   for i in range(PC_SSE)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        sse_ok = all(
            res is not None and res[0] == 200
            and prompts[i] + [d["t"] for n, d, _ in res[1] if n == "token"]
            == solo[i] for i, res in enumerate(results))
        st = server.serving.decode.stats()["models"][DEC_MODEL]
        phase("program cache graph decode", status == 200 and toks == solo
              and sse_ok and st["graphs"]["captures"] >= 1
              and launches["generate"]["flash_fwd"] == 0
              and launches["decoder_load"]["dequantize_rowwise"] == 1,
              f"{len(prompts)} prompts x {DEC_NEW} new -> {status} in "
              f"{json_s:.2f}s, equal to phase 13's solo decodes: "
              f"{toks == solo}; {PC_SSE} SSE streams equal: {sse_ok}; "
              f"graphs {st['graphs']}; K5 at the load "
              f"{launches['decoder_load']['dequantize_rowwise']}")
        line["decode"] = {
            "json_s": json_s,
            "engine_tok_s": len(prompts) * DEC_NEW / json_s,
            "graphs": st["graphs"], "pools": st["pools"],
            "step_ms": time_decode_steps(served, dec["warm"])}
        for cell, t in line["decode"]["step_ms"].items():
            print(f"decode step {cell}: graph host-paced "
                  f"{t['graph_host_paced_ms']:.4f} ms, device "
                  f"{t['graph_device_ms']:.4f} ms; eager host-paced "
                  f"{t['eager_host_paced_ms']:.4f} ms, device "
                  f"{t['eager_device_ms']} ms; capture "
                  f"{t['capture_ms']:.1f} ms, graph pool "
                  f"{t['graph_pool_bytes']} B ({card})", flush=True)
        costs_doc = costs.devtime().snapshot()
        line["decode"]["devtime_buckets"] = {
            k: v for k, v in costs_doc["buckets"].items()
            if k.startswith(f"{DEC_MODEL}:dec")}
    finally:
        server.shutdown()
    line["launches"] = launches
    line["phase_s"] = time.perf_counter() - t_phase
    name, _, limit = card.partition(",")
    line = {"card": name.strip(), "power_limit": limit.strip(), **line}
    return {"line": line, "launches": launches}


# -- phase 16: durable warm start and live profiling --------------------------

# (a) the restart drill: two fresh processes over one durable program store.
WS_EPOCHS = 1  # the children's train job: 8 steps at (32, 128)
WS_SERVE_ROWS = tuple(range(1, 9))  # one request each: buckets 1, 2, 4, 8
WS_ANSWER_ATOL = 1e-6
AOT_CHILD_TIMEOUT_S = 300
# (b) a live capture of the serving path.
PROF_CLIENTS = 8
PROF_ROUNDS = 6
PROF_MAX_CAPTURES = 2
PROF_TIMER_BAR_S = 3.0
K1_SYMBOL = "flash_fwd_tc_kernel"  # csrc/flash_fwd.cu


def request_bytes(port, path) -> tuple:
    """GET ``path`` -> (status, raw body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("GET", "/api/learningOrchestra/v1" + path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def aot_child(role: str, tmp: str) -> int:
    """Phase 16's restart-drill process (``chip_smoke.py --aot-child A|B
    DIR``): the port's APIServer on the card over ``DIR/<role>``'s store
    and volumes, the durable program store at ``LO_TPU_AOT_DIR`` (shared by
    both roles) with the boot pre-warm on; it joins the pre-warm thread,
    then drives a BERT-base train job (K1-K3, K4 at its int8
    publication), one predict per row count 1-8 of its artifact (K5 at the
    load, K1 12 a dispatch) and one SSE stream of the DecoderLM the parent
    placed in its volumes (K5 at ``/load``), and writes what it saw to
    ``DIR/<role>/result.json``."""
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.obs import costs
    from learningorchestra_tpu_torch.train import aot_store, compile_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["LO_TPU_COSTS_PEAK_FLOPS"] = repr(COSTS_PEAK_FLOPS)
    root = f"{tmp}/{role}"
    out = {"role": role}
    t0 = time.perf_counter()
    cfg = server_config(root)
    cfg.aot = Config.from_env().aot
    server = APIServer(cfg, device="cuda")
    port = server.start_background()
    thread = server.ctx._aot_prewarm_thread
    if thread is not None:
        thread.join(120)
    out["boot_s"] = time.perf_counter() - t0
    out["prewarm"] = server.ctx.aot_prewarm_stats
    out["prewarm_alive"] = thread is not None and thread.is_alive()
    jobs, launches = {}, {}
    try:
        x, _ = write_token_csv(f"{root}/tokens.csv")
        fit = {"x": "$tokens_x", "y": "$tokens.label", "epochs": WS_EPOCHS,
               "batch_size": TRAIN_SHAPE[0], "shuffle": False,
               "quantize_checkpoint": True}
        for key, path, body in (
                ("tokens", "/dataset/csv", {
                    "datasetName": "tokens",
                    "url": f"file://{root}/tokens.csv"}),
                ("tokens_x", "/transform/projection", {
                    "projectionName": "tokens_x", "datasetName": "tokens",
                    "fields": REST_FIELDS}),
                ("bert", "/model/tensorflow", {
                    "modelName": "bert", "class": "BertModel",
                    "modulePath": "learningorchestra_tpu.models.text",
                    "classParameters": REST_MODEL}),
                ("ws_fit", "/train/tensorflow", {
                    "name": "ws_fit", "parentName": "bert", "method": "fit",
                    "methodParameters": fit})):
            status, meta, secs, counts = rest_job(port, "POST", path, body,
                                                  key)
            jobs[key] = {"status": status, "state": meta.get("jobState"),
                         "seconds": secs,
                         "compileCache": meta.get("compileCache")}
            launches[key] = counts
        _, rows = request(port, "GET", "/train/tensorflow/ws_fit")
        out["losses"] = [r.get("loss") for r in rows
                         if r.get("docType") == "history"]
        answers, latency = [], []
        zero_kernel_counts()
        for n in WS_SERVE_ROWS:
            t1 = time.perf_counter()
            status, body = request(port, "POST", "/serve/ws_fit/predict",
                                   {"instances": x[:n].tolist()})
            latency.append(time.perf_counter() - t1)
            answers.append(body.get("predictions") if status == 200
                           else {"status": status, "body": body})
        launches["serve"] = kernel_counts()
        out["answers"], out["serve_latency_s"] = answers, latency

        def captures():
            st = server.serving.decode.stats()["models"].get(DEC_MODEL, {})
            return st.get("graphs", {}).get("captures", 0)

        zero_kernel_counts()
        t1 = time.perf_counter()
        status, _ = request(port, "POST", f"/serve/{DEC_MODEL}/load")
        out["decoder_load"] = {"status": status,
                               "seconds": time.perf_counter() - t1,
                               "captures": captures()}
        launches["decoder_load"] = kernel_counts()
        zero_kernel_counts()
        prompt = decoder_prompts()[0]
        status, events = read_sse(port, {"prompts": [prompt], "stream": True,
                                         "maxNewTokens": DEC_NEW})
        launches["stream"] = kernel_counts()
        tok = [(d["t"], s) for n, d, s in events if n == "token"]
        out["stream"] = {"status": status, "tokens": [t for t, _ in tok],
                         "ttft_s": tok[0][1] if tok else None,
                         "captures": captures()}
        stats = compile_cache.get_cache().stats()
        out["cache"] = {k: stats[k] for k in ("hits", "misses", "entries")}
        out["analyses"] = costs.get_ledger().analyses
        out["aot"] = {k: v for k, v in aot_store.stats_snapshot().items()
                      if k != "entries_detail"}
        out["aot"]["skipped"] = aot_store.get_store().skipped
    finally:
        server.shutdown()
    out["jobs"], out["launches"] = jobs, launches
    with open(f"{root}/result.json.tmp", "w") as fh:
        json.dump(out, fh, default=str)
    os.replace(f"{root}/result.json.tmp", f"{root}/result.json")
    return 0


def _rel_close(a, b, rtol) -> bool:
    return len(a) == len(b) and all(
        isinstance(u, float) and isinstance(v, float)
        and abs(u - v) <= rtol * max(abs(u), abs(v)) for u, v in zip(a, b))


def run_restart_drill(tmp, dec_artifact) -> dict:
    """Phase 16 (a): child A from an empty store, then child B over the
    store A wrote; B must restore every program A stored (its pre-warm's
    hits), resolve every program as a hit with no FLOP analysis, capture
    the restored decode cell's graph at the decoder's load (none during
    its stream), launch K1-K5 as A did, and answer as A did."""
    from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE
    from learningorchestra_tpu_torch.store.volumes import VolumeStorage

    env = {**os.environ, "LO_TPU_AOT_ENABLED": "1",
           "LO_TPU_AOT_PREWARM": "1", "LO_TPU_AOT_DIR": f"{tmp}/aot"}
    runs = {}
    for role in ("A", "B"):
        VolumeStorage(f"{tmp}/{role}").save_object(ARTIFACT_TYPE, DEC_MODEL,
                                                   dec_artifact)
        t0 = time.perf_counter()
        with open(f"{tmp}/{role}.log", "w") as log:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--aot-child",
                 role, tmp], env=env, stdout=log, stderr=subprocess.STDOUT,
                timeout=AOT_CHILD_TIMEOUT_S)
        res = _read_json(f"{tmp}/{role}/result.json")
        if proc.returncode != 0 or res is None:
            with open(f"{tmp}/{role}.log") as log:
                tail = log.read()[-3000:]
            raise RuntimeError(f"child {role} exited {proc.returncode}: "
                               f"{tail}")
        res["process_s"] = time.perf_counter() - t0
        runs[role] = res
        print(f"  warm start child {role}: " + json.dumps({
            k: res.get(k) for k in ("process_s", "boot_s", "prewarm",
                                    "cache", "analyses", "aot",
                                    "decoder_load")}, default=str),
              flush=True)
    a, b = runs["A"], runs["B"]
    stored = a["aot"]["persistedEntries"]
    answers_err = max(
        (float(np.max(np.abs(np.asarray(u, np.float64)
                             - np.asarray(v, np.float64))))
         for u, v in zip(a["answers"], b["answers"])), default=math.inf)
    jobs_ok = all(j["status"] in (200, 201) and j["state"] == "finished"
                  for r in (a, b) for j in r["jobs"].values())
    steps = WS_EPOCHS * -(-TRAIN_ROWS // TRAIN_SHAPE[0])
    want_train = {"flash_fwd": REST_LAYERS * steps,
                  "flash_bwd_dq": REST_LAYERS * steps,
                  "flash_bwd_dkv": REST_LAYERS * steps,
                  "quantize_rowwise": 1, "dequantize_rowwise": 0}
    dispatches = len(WS_SERVE_ROWS)
    ok = (jobs_ok and a["launches"] == b["launches"]
          and a["launches"]["ws_fit"] == want_train
          and a["launches"]["serve"]["flash_fwd"] == REST_LAYERS * dispatches
          and a["launches"]["serve"]["dequantize_rowwise"] == 1
          and a["launches"]["decoder_load"]["dequantize_rowwise"] == 1
          and a["launches"]["stream"]["flash_fwd"] == 0
          and stored >= 1 and a["aot"]["loadErrors"] == 0
          and a["analyses"] >= 1 and a["stream"]["captures"] >= 1
          and a["decoder_load"]["captures"] == 0
          and b["prewarm"] is not None and not b["prewarm_alive"]
          and b["prewarm"]["warmed"] == stored
          and b["aot"]["hits"] == stored and b["aot"]["loadErrors"] == 0
          and b["cache"]["misses"] == 0 and b["analyses"] == 0
          and all((j["compileCache"] or {}).get("misses", 0) == 0
                  for j in b["jobs"].values())
          and b["decoder_load"]["captures"] >= 1
          and b["stream"]["captures"] == b["decoder_load"]["captures"]
          and _rel_close(a["losses"], b["losses"], LOSS_RTOL)
          and len(a["losses"]) == WS_EPOCHS
          and answers_err <= WS_ANSWER_ATOL
          and a["stream"]["status"] == b["stream"]["status"] == 200
          and len(a["stream"]["tokens"]) == DEC_NEW
          and a["stream"]["tokens"] == b["stream"]["tokens"])
    line = {role: {
        "job_s": r["jobs"]["ws_fit"]["seconds"],
        "first_answer_s": r["serve_latency_s"][0],
        "serve_latency_s": r["serve_latency_s"],
        "decoder_load_s": r["decoder_load"]["seconds"],
        "ttft_s": r["stream"]["ttft_s"], "boot_s": r["boot_s"],
        "prewarm": r["prewarm"], "process_s": r["process_s"],
        "store_bytes": r["aot"]["persistedBytes"],
        "store_entries": r["aot"]["persistedEntries"],
        "aot": r["aot"], "cache": r["cache"], "analyses": r["analyses"],
        "captures": [r["decoder_load"]["captures"],
                     r["stream"]["captures"]],
        "launches": r["launches"],
        "train_compile_cache": r["jobs"]["ws_fit"]["compileCache"]}
        for role, r in runs.items()}
    line["losses"] = [a["losses"], b["losses"]]
    line["answers_max_abs_diff"] = answers_err
    phase("warm start restart drill", ok,
          f"child A stored {stored} programs ({a['aot']['persistedBytes']} "
          f"B; {a['analyses']} FLOP analyses, misses "
          f"{a['cache']['misses']}); child B pre-warmed {b['prewarm']}, aot "
          f"hits {b['aot']['hits']}, misses {b['cache']['misses']}, "
          f"analyses {b['analyses']}, load errors {b['aot']['loadErrors']}; "
          f"decode graphs captured at the load / by the stream: A "
          f"{line['A']['captures']}, B {line['B']['captures']}; launches "
          f"equal {a['launches'] == b['launches']} ({a['launches']}); "
          f"losses {line['losses']} (rtol {LOSS_RTOL}); answers max |diff| "
          f"{answers_err:.3g} (bar {WS_ANSWER_ATOL}); tokens equal "
          f"{a['stream']['tokens'] == b['stream']['tokens']}; job s "
          f"{line['A']['job_s']:.2f} / {line['B']['job_s']:.2f}, first "
          f"answer s {line['A']['first_answer_s']:.3f} / "
          f"{line['B']['first_answer_s']:.3f}, TTFT s "
          f"{line['A']['ttft_s']} / {line['B']['ttft_s']}")
    return {"line": line,
            "launches": [r["launches"] for r in runs.values()]}


def unrecorded_launches(events: list) -> tuple:
    """A trace's runtime launches and copies that have no device record
    (where the profiler lost the card's side of the work), and all of
    them, in time order."""
    device = {e["args"]["correlation"] for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "correlation" in e.get("args", {})}
    runtime = sorted(
        (e for e in events if e.get("cat") == "cuda_runtime"
         and ("Launch" in e["name"] or "Memcpy" in e["name"])),
        key=lambda e: e["ts"])
    return ([e for e in runtime
             if e.get("args", {}).get("correlation") not in device],
            runtime)


def run_live_capture(tmp, bert_artifact) -> dict:
    """Phase 16 (b): a live ``torch.profiler`` capture over REST of a
    served int8 BERT-base: 8 concurrent predicts at T=128 (dispatched by
    the batcher's thread) under a capture started from a REST thread; the
    trace's K1 kernel events against K1's launch counter over the
    capture, and no traced launch without its device record; the same
    count under a bare ``torch.profiler`` start for comparison; the serve
    p50 with and without the capture; a second start's 409, the
    auto-stop timer, the retention bound and DELETE."""
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.config import ProfilingConfig
    from learningorchestra_tpu_torch.obs import profiling
    from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE
    from learningorchestra_tpu_torch.store.volumes import VolumeStorage

    VolumeStorage(tmp).save_object(ARTIFACT_TYPE, "bert-base", bert_artifact)
    cfg = server_config(tmp)
    cfg.profiling = ProfilingConfig(max_captures=PROF_MAX_CAPTURES)
    server = APIServer(cfg, device="cuda")
    port = server.start_background()
    rng = np.random.default_rng(16)
    reqs = [rng.integers(1, 30522, (n, TRAIN_SHAPE[2])).astype(np.int32)
            for n in range(1, PROF_CLIENTS + 1)]
    launches, line = {}, {}

    def burst():
        def one(x):
            t0 = time.perf_counter()
            status, body = request(port, "POST", "/serve/bert-base/predict",
                                   {"instances": x.tolist()})
            return status, time.perf_counter() - t0, body

        with concurrent.futures.ThreadPoolExecutor(PROF_CLIENTS) as pool:
            return list(pool.map(one, reqs))

    try:
        zero_kernel_counts()
        request(port, "POST", "/serve/bert-base/load")
        for x in reqs:  # every bucket built and analyzed before timing
            request(port, "POST", "/serve/bert-base/predict",
                    {"instances": x.tolist()})
        burst()  # the first burst still warms the path: not timed
        launches["warm"] = kernel_counts()
        base = [r for _ in range(PROF_ROUNDS) for r in burst()]
        zero_kernel_counts()
        st_start, started = request(port, "POST",
                                    "/observability/profile/start",
                                    {"name": "live", "maxSeconds": 60})
        st_dup, dup = request(port, "POST", "/observability/profile/start",
                              {"name": "second"})
        captured = [r for _ in range(PROF_ROUNDS) for r in burst()]
        launches["capture"] = kernel_counts()
        t0 = time.perf_counter()
        st_stop, stopped = request(port, "POST",
                                   "/observability/profile/stop", {})
        stop_s = time.perf_counter() - t0
        # Without the capture again, after it: the p50 without reads both
        # windows around the captured one.
        base += [r for _ in range(PROF_ROUNDS) for r in burst()]
        files = stopped.get("capture", {}).get("files", [])
        trace = [f["path"] for f in files
                 if f["path"].endswith(".pt.trace.json")]
        st_file, raw = request_bytes(
            port, f"/observability/profile/captures/live?file={trace[0]}"
        ) if trace else (0, b"{}")
        events = json.loads(raw).get("traceEvents", [])
        k1_events = sum(1 for e in events if e.get("cat") == "kernel"
                        and K1_SYMBOL in str(e.get("name", "")))
        kernel_events = sum(1 for e in events if e.get("cat") == "kernel")
        unrecorded, runtime = unrecorded_launches(events)
        unrecorded_ms = (unrecorded[-1]["ts"] - runtime[0]["ts"]) / 1e3 \
            if unrecorded else 0.0
        # The comparison: the same traffic under a bare torch.profiler
        # start (no warm-up, obs/profiling.py::start_warm): what a capture
        # loses without it, late in this process.
        bare = profiling.new_profile()
        bare.start()
        for _ in range(2):
            burst()
        bare.stop()
        bare_path = os.path.join(tmp, "bare.pt.trace.json")
        bare.export_chrome_trace(bare_path)
        with open(bare_path) as fh:
            bare_lost, bare_runtime = unrecorded_launches(
                json.load(fh).get("traceEvents", []))
        # (auto-stop) a 1 s capture stopped by its timer.
        t0 = time.perf_counter()
        st_timer, _ = request(port, "POST", "/observability/profile/start",
                              {"name": "timer", "maxSeconds": 1})
        while time.perf_counter() - t0 < 2 * PROF_TIMER_BAR_S:
            _, status_doc = request(port, "GET", "/observability/profile")
            if status_doc["active"] is None and status_doc["autoStops"]:
                break
            time.sleep(0.05)
        timer_s = time.perf_counter() - t0
        # A third capture: the retention bound prunes the oldest ("live").
        request(port, "POST", "/observability/profile/start",
                {"name": "extra"})
        request(port, "POST", "/observability/profile/stop", {})
        _, listed = request(port, "GET", "/observability/profile/captures")
        names = [c["name"] for c in listed.get("captures", [])]
        st_del, _ = request(port, "DELETE",
                            "/observability/profile/captures/extra")
        st_del2, _ = request(port, "DELETE",
                             "/observability/profile/captures/extra")
    finally:
        server.shutdown()
    k1 = launches["capture"]["flash_fwd"]
    p50 = [float(np.median([s for _, s, _ in rs])) for rs in (base,
                                                              captured)]
    # Each burst's own median: the spread an overhead must leave to be
    # read as one.
    burst_p50 = [[float(np.median([s for _, s, _ in rs[i:i + PROF_CLIENTS]]))
                  for i in range(0, len(rs), PROF_CLIENTS)]
                 for rs in (base, captured)]
    resolved = (min(burst_p50[1]) > max(burst_p50[0])
                or max(burst_p50[1]) < min(burst_p50[0]))
    served_ok = all(st == 200 and len(b.get("predictions", [])) == len(x)
                    for rs in (base, captured)
                    for (st, _, b), x in zip(rs, reqs * 2 * PROF_ROUNDS))
    ok = (served_ok and st_start == 201 and st_dup == 409
          and st_stop == 200 and st_file == 200 and k1 > 0
          and k1 % REST_LAYERS == 0 and k1_events == k1 and not unrecorded
          and st_timer == 201 and timer_s <= PROF_TIMER_BAR_S
          and status_doc["autoStops"] == 1
          and len(names) <= PROF_MAX_CAPTURES and "live" not in names
          and st_del == 200 and st_del2 == 404)
    line.update({
        "trace_bytes": len(raw), "trace_events": len(events),
        "kernel_events": kernel_events, "k1_events": k1_events,
        "launches_without_device_record": len(unrecorded),
        "their_span_ms": unrecorded_ms,
        "bare_start": {"launches": len(bare_runtime),
                       "without_device_record": len(bare_lost)},
        "k1_launches": k1, "dispatches": k1 // REST_LAYERS,
        "serve_p50_s": {"without": p50[0], "with": p50[1]},
        "capture_overhead": p50[1] / p50[0] - 1,
        "burst_p50_s": {"without": burst_p50[0], "with": burst_p50[1]},
        "overhead_resolved": resolved, "stop_s": stop_s,
        "timer_stop_s": timer_s, "retained": names,
        "launches": launches})
    phase("warm start live capture", ok,
          f"start {st_start}, second start {st_dup} "
          f"({dup.get('error', '')[:60]}), stop {st_stop} in {stop_s:.2f}s, "
          f"?file= {st_file}: {len(raw)} B, {len(events)} events, "
          f"{kernel_events} kernels, {k1_events} {K1_SYMBOL} events vs K1 "
          f"launch counter {k1} over the capture ({k1 // REST_LAYERS} "
          f"dispatches x {REST_LAYERS}); {len(unrecorded)} of "
          f"{len(runtime)} traced launches/copies without a device record, "
          f"within the first {unrecorded_ms:.1f} ms of the capture's work "
          f"(a bare torch.profiler start over 2 bursts: {len(bare_lost)} of "
          f"{len(bare_runtime)}); "
          f"serve p50 {p50[0] * 1e3:.1f} ms "
          f"without, {p50[1] * 1e3:.1f} ms with the capture over "
          f"{len(base)} / {len(captured)} requests (burst medians "
          f"{min(burst_p50[0]) * 1e3:.1f}-{max(burst_p50[0]) * 1e3:.1f} / "
          f"{min(burst_p50[1]) * 1e3:.1f}-{max(burst_p50[1]) * 1e3:.1f} ms: "
          f"{'resolved' if resolved else 'not resolved'}); 1 s capture "
          f"stopped by its timer in {timer_s:.2f}s (autoStops "
          f"{status_doc['autoStops']}); retained {names} (max "
          f"{PROF_MAX_CAPTURES}); DELETE {st_del}, again {st_del2}")
    return {"line": line, "launches": launches}


def run_warm_start(tmp, card: str, bert_artifact, dec_artifact) -> dict:
    """Phase 16: (a) the restart drill in two child processes, (b) a live
    capture in this process."""
    t_phase = time.perf_counter()
    drill = run_restart_drill(f"{tmp}/drill", dec_artifact)
    live = run_live_capture(f"{tmp}/live", bert_artifact)
    name, _, limit = card.partition(",")
    line = {"card": name.strip(), "power_limit": limit.strip(),
            "restart_drill": drill["line"], "live_capture": live["line"],
            "phase_s": time.perf_counter() - t_phase}
    return {"line": line, "launches": {"children": drill["launches"],
                                       "live": live["launches"]}}


# -- phase 17: mixture-of-experts models -------------------------------------

# The JAX package's defaults (learningorchestra_tpu/models/moe.py:148,200),
# created over REST with no widths given: the decoder LM at vocab 32000,
# 256 wide, 4 layers of 8 heads (head dim 32), MLP 1024, 1024 positions;
# the classifier at vocab 20000, 128 wide, 2 layers of 4 heads, 256
# positions; both with 8 experts, top-2, capacity 1.5, an MoE FFN on every
# second block.  Depth is not cut; the fits are a few steps.
MOE_PATH = "learningorchestra_tpu.models.moe"
MOE_LM, MOE_CLS = "moe_lm", "moe_cls"
MOE_LM_SHAPE = {"vocab_size": 32000, "hidden_dim": 256, "num_layers": 4,
                "num_heads": 8, "max_len": 1024, "num_experts": 8}
MOE_CLS_SHAPE = {"vocab_size": 20000, "hidden_dim": 128, "num_layers": 2,
                 "num_heads": 4, "max_len": 256, "num_experts": 8}
MOE_LM_ROWS, MOE_LM_BATCH, MOE_LM_EPOCHS = 32, 8, 2  # 8 steps at T=1024
MOE_CLS_ROWS, MOE_CLS_BATCH, MOE_CLS_EPOCHS = 128, 32, 2  # 8 at T=256
MOE_PERIOD = 128  # the cycle of ids the decoder's rows are cut from
MOE_CPU_ROWS = 2  # the card-vs-CPU forward, at T=1024
# f32 logits of the card's forward (K1's split TF32 in 4 layers, f32
# GEMMs, the router in f32) against the CPU's plain forward.
MOE_LOGIT_BAR = 1e-4
MOE_STREAMS, MOE_NEW = 4, 32
MOE_PROMPT_LENS = (24, 200, 64, 130)
MOE_PREDICTS = 8
# A profiled MoE train step by kernel family (first match wins): the
# routing's elementwise passes, reductions, softmaxes and cumsums beside
# the GEMMs (the dispatch / combine / expert einsums run as batched GEMMs).
MOE_FAMILIES = {**TRAIN_FAMILIES, "softmax": ("softmax",),
                "scan": ("scan", "cumsum"), "reduce": ("reduce",),
                "elementwise": ("elementwise",)}


def moe_rows(n: int, t: int, seed: int) -> np.ndarray:
    """``n`` rows of ``t`` ids in the MoE decoder's vocabulary, each at a
    seeded offset into a fixed cycle of ``MOE_PERIOD`` ids."""
    cyc = np.random.default_rng(17).permutation(
        np.arange(1, MOE_LM_SHAPE["vocab_size"]))[:MOE_PERIOD]
    offs = np.random.default_rng(seed).integers(0, MOE_PERIOD, n)
    idx = (offs[:, None] + np.arange(t)[None, :]) % MOE_PERIOD
    return cyc[idx].astype(np.int32)


def moe_classifier_rows(n: int, seed: int) -> np.ndarray:
    """``n`` rows at the classifier's max_len, seeded pad tails."""
    t = MOE_CLS_SHAPE["max_len"]
    rng = np.random.default_rng(seed)
    x = rng.integers(1, MOE_CLS_SHAPE["vocab_size"], (n, t)).astype(np.int32)
    for r, keep in enumerate(rng.integers(16, t + 1, n)):
        x[r, keep:] = 0
    return x


def moe_fit(server, port, name: str, cls: str, shape: dict, x, y,
            epochs: int, batch: int) -> tuple:
    """POST /model/tensorflow (the JAX package's module path, default
    widths), then /train/tensorflow over ``x``/``y`` in bf16 on f32
    masters: the job's launches, the card's peak memory over the fit, and
    the trained f32 estimator loaded back on the card."""
    from torch.func import functional_call

    from learningorchestra_tpu_torch.train.neural import _cast_params

    status, meta, model_s, _ = rest_job(
        port, "POST", "/model/tensorflow",
        {"name": name, "modulePath": MOE_PATH, "class": cls,
         "classParameters": {"seed": 0}}, name)
    phase(f"moe {name} model", status == 201 and bool(meta.get("finished")),
          f"POST /model/tensorflow {MOE_PATH}.{cls} -> {status}, "
          f"finished {meta.get('finished')} in {model_s:.2f}s")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fit_name = f"{name}_fit"
    status, meta, fit_s, counts = rest_job(
        port, "POST", "/train/tensorflow",
        {"name": fit_name, "modelName": name, "parentName": name,
         "method": "fit", "methodParameters": {
             "x": x.tolist(), "y": y.tolist(), "epochs": epochs,
             "batch_size": batch}}, fit_name)
    peak = torch.cuda.max_memory_allocated() - resident
    trained = server.ctx.volumes.load_estimator(
        "train/tensorflow", fit_name, device="cuda")
    widths = {k: getattr(trained, k) for k in shape}
    per_epoch = -(-len(x) // batch)
    steps = epochs * per_epoch
    layers = shape["num_layers"]
    want = {k: layers * steps
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    losses = list(trained.history["loss"])
    # The objective of the first batch on the trained masters, under the
    # fit's bf16 cast: the loss and the MoE layers' aux terms beside it.
    aux: list = []
    with torch.no_grad():
        xb = torch.from_numpy(x[:batch]).to(trained.device)
        logits = functional_call(
            trained.module, _cast_params(trained.module, torch.bfloat16),
            (xb,), {"aux_losses": aux}).float()
        loss, _ = trained._loss_and_metrics("softmax_ce")(
            logits, torch.from_numpy(y[:batch]).to(trained.device),
            torch.ones(batch, device=trained.device))
    aux_terms = [float(a) for a in aux]
    moe_layers = layers // trained.moe_every
    step_ms = 1e3 * trained.history["epoch_time"][-1] / per_epoch
    phase(f"moe {name} fit", status == 201 and bool(meta.get("finished"))
          and widths == shape and all(math.isfinite(v) for v in losses)
          and len(aux_terms) == moe_layers
          and all(math.isfinite(a) and a > 0 for a in aux_terms)
          and all(counts[k] == v for k, v in want.items()),
          f"{cls}({widths}) over REST: {len(x)} rows T={x.shape[1]}, batch "
          f"{batch}, {epochs} epoch(s) x {per_epoch} steps, bf16 / f32 "
          f"masters: loss {losses}; first batch after the fit: loss "
          f"{float(loss):.6f} + aux {aux_terms} ({moe_layers} MoE layers) = "
          f"{float(loss) + sum(aux_terms):.6f}; launches "
          f"{ {k: counts[k] for k in want} } (want {layers} layers x "
          f"{steps} steps each); job {fit_s:.2f}s, last epoch's step "
          f"{step_ms:.2f} ms; peak memory over the fit "
          f"{peak / 2**20:.1f} MiB above {resident / 2**20:.1f} resident")
    return trained, {
        "losses": losses, "aux_first_batch": aux_terms,
        "loss_first_batch": float(loss), "job_s": fit_s,
        "fit_time_s": meta.get("fitTime"), "step_ms": step_ms,
        "tokens_per_s": batch * x.shape[1] / (step_ms / 1e3),
        "peak_mib": peak / 2**20, "resident_mib": resident / 2**20,
        "launches": counts}


def publish_int8(server, port, volumes, trained, name: str) -> dict:
    """The trained model saved as an int8 artifact (K4) and loaded by the
    server (K5), each with the counters at 0 just before and read just
    after, every leaf of it held against the trained and the served
    estimator by :func:`artifact_leaves`."""
    from learningorchestra_tpu_torch.ops import quant
    from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE

    zero_kernel_counts()
    t0 = time.perf_counter()
    artifact = trained.to_artifact(quantize=True)
    volumes.save_object(ARTIFACT_TYPE, name, artifact)
    k4 = kernel_counts()
    save_s = time.perf_counter() - t0
    zero_kernel_counts()
    t0 = time.perf_counter()
    status, _ = request(port, "POST", f"/serve/{name}/load")
    k5 = kernel_counts()
    load_s = time.perf_counter() - t0
    served = server.serving.registry.get(name).estimator
    held = artifact_leaves(artifact, trained, served)
    return {"artifact": artifact, "served": served, "status": status,
            "save_s": save_s, "load_s": load_s, "k4": k4, "k5": k5,
            "held": held, "n_launch": -(-len(held["int8"])
                                        // quant.MAX_LEAVES)}


def moe_publish(server, port, volumes, trained, name: str) -> dict:
    """:func:`publish_int8` of an MoE model: at least one expert leaf must
    be int8 (a leaf under the 4,096-element floor stays f32)."""
    from learningorchestra_tpu_torch.ops.moe import EXPERT_LEAVES

    pub = publish_int8(server, port, volumes, trained, name)
    artifact, served, held = pub["artifact"], pub["served"], pub["held"]
    status, k4, k5 = pub["status"], pub["k4"], pub["k5"]
    save_s, load_s, n_launch = pub["save_s"], pub["load_s"], pub["n_launch"]
    n_quant = len(held["int8"])

    def expert(leaf):
        return leaf.rsplit("/", 1)[-1] in EXPERT_LEAVES

    int8_experts = [n for n, _ in held["int8"] if expert(n)]
    f32_experts = [n for n in held["f32"] if expert(n)]
    phase(f"moe {name} int8 artifact", status == 200 and not held["bad"]
          and int8_experts and k4["quantize_rowwise"] == n_launch
          and k5["dequantize_rowwise"] == n_launch,
          f"save {save_s:.2f}s (K4 {k4['quantize_rowwise']} launch over "
          f"{n_quant} leaves), POST /serve/{name}/load -> {status} in "
          f"{load_s:.2f}s (K5 {k5['dequantize_rowwise']}; want {n_launch} "
          f"each); every leaf: {n_quant} int8 (bits equal to the plain "
          f"quantize, served values equal to the plain dequantize, max|d| "
          f"{held['max_abs_err']}), {len(held['f32'])} f32 served "
          f"unchanged; expert leaves {len(int8_experts)} int8, "
          f"{len(f32_experts)} f32; failing {held['bad']}")
    return {"artifact": artifact, "served": served, "save_s": save_s,
            "load_s": load_s, "k4": k4, "k5": k5, "int8_leaves": n_quant,
            "f32_leaves": len(held["f32"]),
            "expert_leaves": len(int8_experts) + len(f32_experts),
            "int8_expert_leaves": len(int8_experts)}


def moe_vs_cpu(trained) -> dict:
    """The trained decoder's forward on the card against the port's CPU
    plain forward from the same weights: f32 logits within MOE_LOGIT_BAR,
    the share of tokens whose top-k experts agree in every MoE layer, and
    the tokens whose top-k set differs when the card runs the fit's bf16
    cast instead."""
    import torch.nn.functional as F
    from torch.func import functional_call

    from learningorchestra_tpu_torch import convert
    from learningorchestra_tpu_torch.models.moe import MoEDecoderLM
    from learningorchestra_tpu_torch.ops.moe import MoEMlp
    from learningorchestra_tpu_torch.train.neural import _cast_params

    t0 = time.perf_counter()
    kwargs = {k: v for k, v in trained.get_params().items() if k != "device"}
    cpu = MoEDecoderLM(**kwargs, device="cpu")
    cpu.load_state_dict({"params": convert.params_to_jax(trained.module)})
    x = moe_rows(MOE_CPU_ROWS, MOE_LM_SHAPE["max_len"], seed=9)
    x[1, 700:] = 0  # a pad tail
    routes: dict = {}

    def forward(est, key, params=None):
        handles = []
        for name, mod in est.module.named_modules():
            if isinstance(mod, MoEMlp):
                def pre(m, args, name=name):
                    logits = F.linear(args[0].float(),
                                      m.router.weight.float())
                    routes.setdefault(key, {})[name] = torch.topk(
                        logits, m.top_k, dim=-1).indices.sort(-1).values.cpu()
                handles.append(mod.register_forward_pre_hook(pre))
        try:
            with torch.inference_mode():
                xt = torch.from_numpy(x).to(est.device)
                out = est.module(xt) if params is None else \
                    functional_call(est.module, params, (xt,))
                return out.float().cpu()
        finally:
            for h in handles:
                h.remove()

    zero_kernel_counts()
    card = forward(trained, "card")
    f32_launches = kernel_counts()
    ref = forward(cpu, "cpu")
    zero_kernel_counts()
    bf16 = forward(trained, "bf16",
                   _cast_params(trained.module, torch.bfloat16))
    bf16_launches = kernel_counts()
    err = float((card - ref).abs().max())
    tokens = sum(v.shape[0] * v.shape[1] for v in routes["cpu"].values())

    def agree(key):
        return sum(int((routes[key][n] == routes["cpu"][n]).all(-1).sum())
                   for n in routes["cpu"])

    share = agree("card") / tokens
    bf16_flips = tokens - agree("bf16")
    bf16_err = float((bf16 - ref).abs().max())
    phase("moe card vs CPU forward", err <= MOE_LOGIT_BAR
          and bool(torch.isfinite(card).all())
          and f32_launches["flash_fwd"] == MOE_LM_SHAPE["num_layers"],
          f"trained MoEDecoderLM f32, {MOE_CPU_ROWS} rows at T={x.shape[1]} "
          f"(second with a pad tail): logits max|d| {err:.3g} (bar "
          f"{MOE_LOGIT_BAR}); top-{trained.top_k} experts equal for "
          f"{100 * share:.2f} % of {tokens} token-layer routings; the fit's "
          f"bf16 cast on the card: {bf16_flips} routings differ, logits "
          f"max|d| {bf16_err:.3g}; K1 {f32_launches['flash_fwd']} launches "
          f"f32 (want {MOE_LM_SHAPE['num_layers']}), "
          f"{bf16_launches['flash_fwd']} bf16 (CPU side "
          f"{time.perf_counter() - t0:.1f}s)")
    return {"max_abs_err": err, "route_agreement": share,
            "routings": tokens, "bf16_route_flips": bf16_flips,
            "bf16_max_abs_err": bf16_err, "launches_f32": f32_launches,
            "launches_bf16": bf16_launches}


def run_moe(tmp, card: str) -> dict:
    """Phase 17: the mixture-of-experts models through the port's entry
    points on the card: both fitted over REST at the JAX package's
    default widths (K1/K2/K3 one each per layer per step), published as
    int8 artifacts (K4) and loaded by the server (K5) with every leaf
    held against the plain versions; the classifier's ``/predict``;
    ``/generate`` SSE streams of the decoder through the CUDA-graph decode
    step, two admitted while two are mid-flight, each equal to a solo
    ``generate``; the decoder's card forward against the CPU's; a profiled
    decoder step; the ``moe`` line.  K1-K3 at the decoder's attention
    shape are timed in phase 3 (``time_bwd``)."""
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.store.volumes import VolumeStorage
    from learningorchestra_tpu_torch.train.neural import load_artifact

    t_phase = time.perf_counter()
    line: dict = {}
    launches: dict = {}
    volumes = VolumeStorage(tmp)
    server = APIServer(server_config(tmp), device="cuda")
    port = server.start_background()
    try:
        # The decoder LM: 32 rows of T=1024 cut from a seeded cycle.
        x = moe_rows(MOE_LM_ROWS, MOE_LM_SHAPE["max_len"], seed=1)
        y = np.concatenate([x[:, 1:], np.zeros((len(x), 1), np.int32)], 1)
        lm, line["lm_fit"] = moe_fit(
            server, port, MOE_LM, "MoEDecoderLM", MOE_LM_SHAPE, x, y,
            MOE_LM_EPOCHS, MOE_LM_BATCH)
        launches["lm_train"] = line["lm_fit"]["launches"]
        line["vs_cpu"] = moe_vs_cpu(lm)
        launches["forward_f32"] = line["vs_cpu"].pop("launches_f32")
        launches["forward_bf16"] = line["vs_cpu"].pop("launches_bf16")
        pub = moe_publish(server, port, volumes, lm, MOE_LM)
        launches["lm_publish"], launches["lm_load"] = pub["k4"], pub["k5"]
        line["lm_artifact"] = {k: pub[k] for k in (
            "save_s", "load_s", "int8_leaves", "f32_leaves",
            "expert_leaves", "int8_expert_leaves")}
        served = pub["served"]

        # /generate: 4 SSE streams, the last 2 opened while the first 2
        # are mid-flight, each against a solo generate on the card.
        prompts = [moe_rows(1, n, seed=100 + i)[0].tolist()
                   for i, n in enumerate(MOE_PROMPT_LENS)]
        first_tok = [threading.Event() for _ in range(MOE_STREAMS)]
        results = [None] * MOE_STREAMS

        def sse(i):
            results[i] = read_sse(
                port, {"prompts": [prompts[i]], "stream": True,
                       "maxNewTokens": MOE_NEW},
                on_token=lambda doc, n, i=i: first_tok[i].set(),
                model=MOE_LM)

        zero_kernel_counts()
        threads = [threading.Thread(target=sse, args=(i,))
                   for i in range(MOE_STREAMS)]
        for th in threads[:2]:
            th.start()
        first_tok[0].wait(120)
        midflight = not any(results[:2])
        for th in threads[2:]:
            th.start()
        for th in threads:
            th.join(300)
        launches["lm_generate"] = kernel_counts()
        ttft, itl, ok, div = [], [], True, []
        for prompt, res in zip(prompts, results):
            status, events = res or (0, [])
            tok = [(d["t"], s) for n, d, s in events if n == "token"]
            names = [n for n, _, _ in events]
            ok &= status == 200 and names[:1] == ["open"] and \
                names[-1:] == ["done"] and len(tok) == MOE_NEW
            if tok:
                ttft.append(tok[0][1] * 1e3)
                itl += [(b - a) * 1e3 for (_, a), (_, b) in
                        zip(tok, tok[1:])]
            solo = served.generate(np.asarray([prompt], np.int32),
                                   max_new_tokens=MOE_NEW)[0].tolist()
            div.append(first_divergence([t for t, _ in tok],
                                        solo[len(prompt):]))
        st = server.serving.decode.stats()["models"][MOE_LM]
        phase("moe generate streams", ok and midflight
              and all(d is None for d in div)
              and st["graphs"].get("captures", 0) >= 1
              and launches["lm_generate"]["flash_fwd"] == 0,
              f"{MOE_STREAMS} SSE streams of prompts {list(MOE_PROMPT_LENS)} "
              f"tokens, {MOE_NEW} new each, 2 admitted while 2 were mid-"
              f"flight: {midflight}; first divergence from a solo generate "
              f"{div} (None: equal); decode graphs {st['graphs']}; K1 "
              f"{launches['lm_generate']['flash_fwd']} (want 0: one query "
              f"attends the cache in plain torch)")
        warm = dict(server.serving.registry.get(MOE_LM).decode_warm)
        line["generate"] = {
            "streams": MOE_STREAMS, "new_tokens": MOE_NEW,
            "first_divergence": div, "graphs": st["graphs"],
            "ttft_ms": {"p50": float(np.median(ttft)),
                        "max": float(np.max(ttft))},
            "itl_ms": {"p50": float(np.median(itl)),
                       "p99": float(np.percentile(itl, 99))},
            "step_ms": time_decode_steps(served, warm, rows=moe_rows)}
        del served, pub
        # Last, since it steps the trained decoder further: the published
        # and served model above is the /train/tensorflow job's own.
        try:
            line["lm_fit"]["profile"] = profile_step(
                lm, x[:MOE_LM_BATCH], y[:MOE_LM_BATCH], MOE_FAMILIES)
        except Exception as exc:  # noqa: BLE001 — where CUPTI tracing is
            # unavailable this breakdown is reported as not measured.
            line["lm_fit"]["profile"] = {"not_measured": repr(exc)}
        del lm

        # The classifier: 128 rows at T=256 with pad tails, two epochs.
        xc = moe_classifier_rows(MOE_CLS_ROWS, seed=3)
        yc = (xc[:, 0] % 2).astype(np.int32)
        cls, line["cls_fit"] = moe_fit(
            server, port, MOE_CLS, "MoETransformerClassifier", MOE_CLS_SHAPE,
            xc, yc, MOE_CLS_EPOCHS, MOE_CLS_BATCH)
        launches["cls_train"] = line["cls_fit"]["launches"]
        pub = moe_publish(server, port, volumes, cls, MOE_CLS)
        launches["cls_publish"], launches["cls_load"] = pub["k4"], pub["k5"]
        line["cls_artifact"] = {k: pub[k] for k in (
            "save_s", "load_s", "int8_leaves", "f32_leaves",
            "expert_leaves", "int8_expert_leaves")}
        del cls
        rng = np.random.default_rng(31)
        reqs = [moe_classifier_rows(int(rng.integers(1, 9)), seed=40 + i)
                for i in range(MOE_PREDICTS)]
        zero_kernel_counts()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(MOE_PREDICTS) as pool:
            answers = list(pool.map(lambda r: request(
                port, "POST", f"/serve/{MOE_CLS}/predict",
                {"instances": r.tolist()}), reqs))
        wall_s = time.perf_counter() - t0
        launches["cls_serve"] = kernel_counts()
        _, listing = request(port, "GET", "/serve")
        dispatches = listing["stats"]["models"][MOE_CLS]["batches"]
        preds = [np.asarray(b.get("predictions", []), np.float32)
                 for _, b in answers]
        ok = all(s == 200 and p.shape == (len(r), 2)
                 and bool(np.isfinite(p).all())
                 for (s, _), p, r in zip(answers, preds, reqs))
        ref = load_artifact(pub["artifact"], device="cpu").predict(
            np.concatenate([reqs[0], reqs[-1]]))
        err = float(np.abs(np.concatenate([preds[0], preds[-1]])
                           - ref).max()) if ok else math.inf
        lat = sorted(b.get("latencyMs", 0.0) for _, b in answers)
        layers = MOE_CLS_SHAPE["num_layers"]
        phase("moe classifier predict", ok and err <= CPU_ATOL
              and launches["cls_serve"]["flash_fwd"] == layers * dispatches,
              f"{MOE_PREDICTS} concurrent POST /serve/{MOE_CLS}/predict of "
              f"{[len(r) for r in reqs]} rows at T={MOE_CLS_SHAPE['max_len']}"
              f": statuses {sorted({s for s, _ in answers})}, {dispatches} "
              f"dispatches, K1 {launches['cls_serve']['flash_fwd']} (want "
              f"{layers} x {dispatches}); two requests' rows against the "
              f"int8 artifact on the CPU max|d| {err:.3g} (atol {CPU_ATOL})")
        line["cls_predict"] = {"requests": MOE_PREDICTS, "wall_s": wall_s,
                               "dispatches": dispatches,
                               "latency_ms_p50": lat[len(lat) // 2],
                               "latency_ms_max": lat[-1],
                               "cpu_max_abs_err": err}
    finally:
        server.shutdown()
    torch.cuda.empty_cache()
    line["launches"] = launches
    line["phase_s"] = time.perf_counter() - t_phase
    name, _, limit = card.partition(",")
    line = {"card": name.strip(), "power_limit": limit.strip(), **line}
    return {"line": line, "launches": launches}


# -- phase 18: long-context training over a sequence-parallel ring -----------

# LongContextTransformer at the JAX package's defaults
# (learningorchestra_tpu/models/longcontext.py:101): vocab 32000, 256 wide,
# 4 layers of 8 heads (head dim 32), MLP 1024, 65,536 positions, 2
# classes, not causal.  Depth is not cut; the fits are a few steps.
LONG_PATH = "learningorchestra_tpu.models.longcontext"
LONG_MODEL = "long_ctx"
LONG_SHAPE = {"vocab_size": 32000, "hidden_dim": 256, "num_layers": 4,
              "num_heads": 8, "mlp_dim": 1024, "max_len": 65536,
              "num_classes": 2, "causal": False}
LONG_SP = 2  # two gloo ranks on the one card
LONG_DEVICE = "cuda:0"
LONG_CHECK = (2, 4096, 8, 32)  # (a): the ring against plain, (B, T, H, D)
LONG_STEP_T = 4096  # (a)'s f32 step, (c)'s REST fit and /predict
LONG_STEP_BAR = 1e-4  # the f32 sp = 2 step against one device
# Its largest leaf difference over that leaf's largest gradient: sound
# runs read 5.5e-5; an sp-sum fault in a token-local leaf reads of
# order 1.
LONG_LEAF_BAR = 1e-3
LONG_FIT_T, LONG_FIT_EPOCHS = 65536, 2  # (b): 2 steps of 2 rows
LONG_REST_ROWS = 4  # (c): 2 steps of a global batch of 2
LONG_PREDICTS = 8
# Query rows per chunk of the plain version at a ring step's (2, 8,
# 32768, 32): 4.3 GB of f32 scores a chunk, where whole rows take 68.7 GB.
LONG_PLAIN_CHUNK = 2048
LONG_BF16_TOL = 3e-2
RING_CHILD_TIMEOUT_S = 300


def long_rows(n: int, t: int, seed: int) -> np.ndarray:
    """``n`` seeded rows of ``t`` ids in the model's vocabulary; the last
    row ends in a pad tail of t/8 (pad id 0)."""
    x = np.random.default_rng(seed).integers(
        1, LONG_SHAPE["vocab_size"], (n, t)).astype(np.int32)
    x[-1, t - t // 8:] = 0
    return x


def ring_child(tmp: str, rank: int) -> int:
    """(a) of phase 18 in one of two gloo ranks on cuda:0 (``python3
    chip_smoke.py --ring-child DIR RANK``): the port's ``DataParallel``
    makes the sp = 2 ring; ``ring_flash_attention`` at ``LONG_CHECK`` in
    f32 and bf16, causal and not, with a key mask holding a fully masked
    row, its O and dQ/dK/dV (the backward of sum(O * cotangent)) held
    against ``mha_reference`` over the whole sequence at this rank's
    tokens, the masked row exactly 0, K1/K2/K3 counted per case; then one
    f32 train step of the full-width model at T = LONG_STEP_T over the
    ring (the loss divided by sp, the gradients summed over the ranks) and,
    on rank 0, the same step on one device from the same seed.  Writes
    ``DIR/rank<r>.json``."""
    from pathlib import Path

    import torch.distributed as dist

    from learningorchestra_tpu_torch.models.longcontext import (
        LongContextTransformer,
    )
    from learningorchestra_tpu_torch.ops.attention import mha_reference
    from learningorchestra_tpu_torch.parallel.distributed import (
        DataParallel,
        init_process_group,
    )
    from learningorchestra_tpu_torch.parallel.ring_attention import (
        ring_flash_attention,
    )
    from learningorchestra_tpu_torch.parallel.sharding import sequence_slice

    stage = Path(tmp)
    dev = torch.device(LONG_DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_process_group(stage, rank, LONG_SP, "gloo")
    dp = DataParallel(rank, LONG_SP, dev, "gloo", stage / "cancel",
                      sp=LONG_SP)
    ring = dp.ring
    b, t, h, d = LONG_CHECK
    toks = sequence_slice(t, ring.index, LONG_SP)
    out: dict = {"rank": rank, "sp_index": ring.index, "cases": []}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            gen = torch.Generator().manual_seed(7)
            q, k, v, g = (torch.randn(b, t, h, d, generator=gen)
                          for _ in range(4))
            km = torch.rand(b, t, generator=gen) > 0.1
            km[:, 0] = True
            km[1] = False  # row 1: no valid key
            q, k, v = (x.to(dev, dtype) for x in (q, k, v))
            g, km = g.to(dev), km.to(dev)
            mine = [x[:, toks].clone().requires_grad_() for x in (q, k, v)]
            zero_kernel_counts()
            o = ring_flash_attention(*mine, ring=ring, kmask=km[:, toks],
                                     causal=causal)
            (o.float() * g[:, toks]).sum().backward()
            counts = kernel_counts()
            whole = [x.float().requires_grad_() for x in (q, k, v)]
            ref = mha_reference(*(x.transpose(1, 2) for x in whole), km,
                                causal).transpose(1, 2)
            (ref * g).sum().backward()
            errs = {"o": max_abs(o.float(), ref[:, toks])}
            for name, mine_x, whole_x in zip(("dq", "dk", "dv"), mine,
                                             whole):
                errs[name] = max_abs(mine_x.grad.float(),
                                     whole_x.grad[:, toks])
            steps = ring.index + 1 if causal else LONG_SP
            out["cases"].append({
                "dtype": str(dtype).replace("torch.", ""), "causal": causal,
                "errs": errs, "masked_row_zero": bool((o[1] == 0).all()),
                "finite": bool(torch.isfinite(o).all()),
                "launches": counts, "want": steps})
            del q, k, v, g, mine, whole, ref, o
    # The f32 step at full width: sp = 2 against one device.
    x = long_rows(2, LONG_STEP_T, seed=5)
    y = torch.tensor([0, 1], device=dev)
    est = LongContextTransformer(**LONG_SHAPE, seed=0, device=dev)
    loss_fn = est._loss_and_metrics("softmax_ce")
    ones = torch.ones(2, device=dev)
    est.bind_mesh(ring)
    zero_kernel_counts()
    cut = sequence_slice(LONG_STEP_T, ring.index, LONG_SP)
    logits = est.module(torch.from_numpy(x[:, cut]).to(dev))
    loss, _ = loss_fn(logits.float(), y, ones)
    (loss / LONG_SP).backward()
    dp.sync_grads(est.module)
    step_counts = kernel_counts()
    est.bind_mesh(None)
    grads = {n: p.grad for n, p in est.module.named_parameters()}
    out["step"] = {"loss": float(loss), "launches": step_counts,
                   "grad_norm": float(torch.sqrt(sum(
                       (gr.double() ** 2).sum() for gr in grads.values())))}
    if rank == 0:
        one = LongContextTransformer(**LONG_SHAPE, seed=0, device=dev)
        zero_kernel_counts()
        loss1, _ = loss_fn(one.module(torch.from_numpy(x).to(dev)).float(),
                           y, ones)
        loss1.backward()
        one_counts = kernel_counts()
        ref_grads = {n: p.grad for n, p in one.module.named_parameters()}
        out["single"] = {
            "loss": float(loss1), "launches": one_counts,
            "grad_norm": float(torch.sqrt(sum(
                (gr.double() ** 2).sum() for gr in ref_grads.values()))),
            # The largest leaf difference over that leaf's largest entry.
            "max_leaf_rel": max(
                float((grads[n] - gr).abs().max()
                      / gr.abs().max().clamp_min(1e-30))
                for n, gr in ref_grads.items())}
    with open(stage / f"rank{rank}.json", "w") as fh:
        json.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def ring_results(procs: list, stage: str) -> tuple:
    """(a): wait for the ring children (bounded), read their results,
    print the ring and the f32 step's phase lines."""
    deadline = time.monotonic() + RING_CHILD_TIMEOUT_S
    for proc in procs:
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    res = []
    for r, proc in enumerate(procs):
        path = os.path.join(stage, f"rank{r}.json")
        if proc.returncode != 0 or not os.path.exists(path):
            with open(os.path.join(stage, f"rank{r}.log"), "rb") as fh:
                tail = fh.read()[-3000:].decode(errors="replace")
            raise RuntimeError(f"ring child {r} exited {proc.returncode}:"
                               f"\n{tail}")
        with open(path) as fh:
            res.append(json.load(fh))
    tol = {"float32": {"o": 2e-5, "dq": 5e-5, "dk": 5e-5, "dv": 5e-5},
           "bfloat16": {"o": 3e-2, "dq": 3e-2, "dk": 3e-2, "dv": 3e-2}}
    ok, worst = True, {}
    for child in res:
        for case in child["cases"]:
            bar = tol[case["dtype"]]
            n = case["want"]
            ok &= all(case["errs"][k] <= bar[k] for k in bar) and \
                case["masked_row_zero"] and case["finite"] and all(
                    case["launches"][k] == n for k in (
                        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
            key = f"{case['dtype']}{' causal' if case['causal'] else ''}"
            prev = worst.setdefault(key, {k: 0.0 for k in bar})
            for k in bar:
                prev[k] = max(prev[k], case["errs"][k])
    launches = {f"rank{c['rank']}": {
        f"{case['dtype']}{'_causal' if case['causal'] else ''}":
        [case["launches"][k] for k in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")]
        for case in c["cases"]} for c in res}
    b, t, h, d = LONG_CHECK
    phase("long context ring", ok,
          f"ring_flash_attention over 2 gloo ranks on {LONG_DEVICE} at "
          f"(B, T, H, "
          f"D) = {LONG_CHECK}, each rank {t // LONG_SP} tokens, a key mask "
          f"with row 1 fully masked; O and dQ/dK/dV against mha_reference "
          f"over the whole sequence, max|d| by case {worst} (f32 bars 2e-5 "
          f"/ 5e-5, bf16 3e-2); masked row exactly 0 on every rank; K1/K2/"
          f"K3 per rank {launches} (want sp = {LONG_SP} each, a causal "
          f"rank s: s + 1)")
    one = res[0]["single"]
    step = [c["step"] for c in res]
    d_loss = abs(step[0]["loss"] - one["loss"])
    d_norm = abs(step[0]["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
    layers = LONG_SHAPE["num_layers"]
    ok = d_loss <= LONG_STEP_BAR and d_norm <= LONG_STEP_BAR \
        and one["max_leaf_rel"] <= LONG_LEAF_BAR and all(
        s["loss"] == step[0]["loss"] and s["grad_norm"] == step[0][
            "grad_norm"] for s in step) and all(
        s["launches"][k] == layers * LONG_SP for s in step
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    phase("long context f32 step", ok,
          f"LongContextTransformer({LONG_SHAPE}) f32, one step of 2 rows "
          f"at T={LONG_STEP_T} (the second with a pad tail): sp = 2 loss "
          f"{step[0]['loss']:.7f}, grad norm {step[0]['grad_norm']:.7g} "
          f"(equal on both ranks: {all(s == step[0] for s in step)}); one "
          f"device loss {one['loss']:.7f}, grad norm "
          f"{one['grad_norm']:.7g}: |d loss| {d_loss:.3g}, grad norm rel "
          f"{d_norm:.3g} (bar {LONG_STEP_BAR}), largest leaf difference / "
          f"its largest gradient {one['max_leaf_rel']:.3g} (bar "
          f"{LONG_LEAF_BAR}); K1/K2/K3 per "
          f"rank {[s['launches']['flash_fwd'] for s in step]} (want "
          f"{layers} layers x {LONG_SP} steps), one device "
          f"{one['launches']['flash_fwd']}")
    return ({"max_abs_err": worst, "launches": launches},
            {"sp2": step[0], "single": one, "loss_abs_diff": d_loss,
             "grad_norm_rel_diff": d_norm})


def long_fit() -> dict:
    """(b): ``DistributedTrainer(spec=MeshSpec(sp=2))`` over two gloo
    ranks on cuda:0 fits the full-width model 2 bf16 steps of 2 rows at
    T = 65,536 (each rank 32,768 tokens of each row)."""
    from learningorchestra_tpu_torch.models.longcontext import (
        LongContextTransformer,
    )
    from learningorchestra_tpu_torch.parallel import (
        DistributedTrainer,
        MeshSpec,
    )

    est = LongContextTransformer(**LONG_SHAPE, seed=0,
                                 device=LONG_DEVICE)
    x = long_rows(2, LONG_FIT_T, seed=11)
    y = np.array([0, 1], np.int32)
    trainer = DistributedTrainer(est, spec=MeshSpec(sp=LONG_SP),
                                 devices=[LONG_DEVICE] * LONG_SP)
    t0 = time.perf_counter()
    trainer.fit(x, y, epochs=LONG_FIT_EPOCHS, batch_size=2, shuffle=False)
    fit_s = time.perf_counter() - t0
    layers = LONG_SHAPE["num_layers"]
    want = layers * LONG_SP * LONG_FIT_EPOCHS
    ranks = [{"rank": s["rank"], "sp_index": s["sp_index"],
              "launches": s["launches"], "step_ms": s["step_ms"],
              "sync_ms": s["sync_ms"],
              "peak_gib": s.get("peak_memory_bytes", 0) / 2**30,
              "spawn_to_first_step_s": s["spawn_to_first_step_s"]}
             for s in trainer.rank_stats]
    losses = list(trainer.history["loss"])
    ok = trainer.backend == "gloo" and len(ranks) == LONG_SP and all(
        len(r["step_ms"]) == LONG_FIT_EPOCHS and all(
            r["launches"][k] == want for k in (
                "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        for r in ranks) and len(losses) == LONG_FIT_EPOCHS and all(
        math.isfinite(v) for v in losses)
    phase("long context fit", ok,
          f"DistributedTrainer(LongContextTransformer(), MeshSpec(sp=2), "
          f"devices=['{LONG_DEVICE}'] x 2, {trainer.backend}): "
          f"{LONG_FIT_EPOCHS} "
          f"bf16 steps of 2 rows at T={LONG_FIT_T} ({LONG_FIT_T // LONG_SP}"
          f" tokens a rank): losses {losses}; per rank step ms "
          f"{[[round(v, 1) for v in r['step_ms']] for r in ranks]} (the "
          f"gradient all-reduce "
          f"{[[round(v, 1) for v in r['sync_ms']] for r in ranks]}), peak "
          f"memory {[round(r['peak_gib'], 2) for r in ranks]} GiB; K1/K2/"
          f"K3 per rank {[[r['launches'][k] for k in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')] for r in ranks]} "
          f"(want {layers} layers x sp {LONG_SP} x {LONG_FIT_EPOCHS} steps"
          f" = {want}); fit {fit_s:.1f}s, spawn to first step "
          f"{[round(r['spawn_to_first_step_s'], 1) for r in ranks]} s")
    return {"losses": losses, "fit_s": fit_s, "ranks": ranks,
            "want_per_rank": want}


def long_rest(tmp, card: str) -> tuple:
    """(c): the port's server with two lease units of cuda:0: the model
    created over REST at its defaults, ``POST /train/horovod`` with
    ``"mesh": {"sp": 2}`` at T = LONG_STEP_T, the trained model published
    int8 (K4) and loaded (K5) with every leaf held by
    :func:`artifact_leaves`, then ``LONG_PREDICTS`` concurrent
    ``/predict`` requests through K1 on one device, the one-row request
    against the artifact on the CPU."""
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.jobs.leases import DeviceLeaser
    from learningorchestra_tpu_torch.train.neural import load_artifact

    line: dict = {}
    launches: dict = {}
    layers = LONG_SHAPE["num_layers"]
    server = APIServer(server_config(tmp), device=LONG_DEVICE)
    port = server.start_background()
    server.ctx.leaser = server.ctx.engine.leaser = DeviceLeaser(
        [LONG_DEVICE] * LONG_SP)
    probe = TrainerProbe()
    try:
        status, meta, model_s, _ = rest_job(
            port, "POST", "/model/tensorflow",
            {"name": LONG_MODEL, "modulePath": LONG_PATH,
             "class": "LongContextTransformer",
             "classParameters": {"seed": 0}}, LONG_MODEL)
        phase("long context model", status == 201
              and bool(meta.get("finished")),
              f"POST /model/tensorflow {LONG_PATH}.LongContextTransformer "
              f"-> {status}, finished {meta.get('finished')} in "
              f"{model_s:.2f}s")
        x = long_rows(LONG_REST_ROWS, LONG_STEP_T, seed=13)
        y = (np.arange(LONG_REST_ROWS) % 2).astype(np.int32)
        fit_name = f"{LONG_MODEL}_fit"
        status, meta, fit_s, parent = rest_job(
            port, "POST", "/train/horovod",
            {"name": fit_name, "parentName": LONG_MODEL,
             "trainingParameters": {"x": x.tolist(), "y": y.tolist(),
                                    "epochs": 1, "batch_size": 2,
                                    "shuffle": False},
             "mesh": {"sp": LONG_SP}}, fit_name)
        fit = probe.fits[-1] if probe.fits else {"rank_stats": [],
                                                 "world": 0}
        steps = LONG_REST_ROWS // 2
        want = layers * LONG_SP * steps
        ranks = [s["launches"] for s in fit["rank_stats"]]
        launches["rest_ranks"] = ranks
        _, rows = request(port, "GET", f"/train/horovod/{fit_name}")
        history = [r.get("loss") for r in rows
                   if r.get("docType") == "history"]
        phase("long context rest fit", status == 201
              and bool(meta.get("finished")) and fit["world"] == LONG_SP
              and meta.get("mesh") == {"sp": LONG_SP} and len(history) == 1
              and all(math.isfinite(v) for v in history)
              and len(ranks) == LONG_SP and all(
                  r[k] == want for r in ranks for k in (
                      "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
              f"POST /train/horovod mesh {{'sp': {LONG_SP}}}, {LONG_REST_ROWS}"
              f" rows at T={LONG_STEP_T}, batch 2: {meta.get('jobState')} "
              f"in {fit_s:.2f}s (fitTime {meta.get('fitTime')}), world "
              f"{fit['world']}, loss {history}; K1/K2/K3 per rank "
              f"{[[r[k] for k in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')] for r in ranks]}"
              f" (want {want}), parent {parent}")
        line["fit"] = {"job_s": fit_s, "fit_time_s": meta.get("fitTime"),
                       "losses": history, "rank_stats": [
                           {"rank": s["rank"], "step_ms": s["step_ms"],
                            "spawn_to_first_step_s":
                            s["spawn_to_first_step_s"]}
                           for s in fit["rank_stats"]]}
        trained = server.ctx.volumes.load_estimator(
            "train/tensorflow", fit_name, device=LONG_DEVICE)
        name = f"{LONG_MODEL}_int8"
        pub = publish_int8(server, port, server.ctx.volumes, trained, name)
        held = pub["held"]
        launches["publish"], launches["load"] = pub["k4"], pub["k5"]
        phase("long context int8 artifact", pub["status"] == 200
              and not held["bad"] and len(held["int8"]) > 0
              and pub["k4"]["quantize_rowwise"] == pub["n_launch"]
              and pub["k5"]["dequantize_rowwise"] == pub["n_launch"],
              f"save {pub['save_s']:.2f}s (K4 {pub['k4']['quantize_rowwise']}"
              f" launch over {len(held['int8'])} leaves), POST /serve/{name}/"
              f"load -> {pub['status']} in {pub['load_s']:.2f}s (K5 "
              f"{pub['k5']['dequantize_rowwise']}; want {pub['n_launch']} "
              f"each); every leaf: {len(held['int8'])} int8 (bits equal to "
              f"the plain quantize, served values equal to the plain "
              f"dequantize, max|d| {held['max_abs_err']}), "
              f"{len(held['f32'])} f32 served unchanged; failing "
              f"{held['bad']}")
        line["artifact"] = {"save_s": pub["save_s"], "load_s": pub["load_s"],
                            "int8_leaves": len(held["int8"]),
                            "f32_leaves": len(held["f32"])}
        rng = np.random.default_rng(37)
        reqs = [long_rows(1 if i == 0 else int(rng.integers(1, 5)),
                          LONG_STEP_T, seed=50 + i)
                for i in range(LONG_PREDICTS)]
        zero_kernel_counts()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(LONG_PREDICTS) as pool:
            answers = list(pool.map(lambda r: request(
                port, "POST", f"/serve/{name}/predict",
                {"instances": r.tolist()}), reqs))
        wall_s = time.perf_counter() - t0
        launches["predict"] = kernel_counts()
        _, listing = request(port, "GET", "/serve")
        dispatches = listing["stats"]["models"][name]["batches"]
        preds = [np.asarray(b.get("predictions", []), np.float32)
                 for _, b in answers]
        ok = all(s == 200 and p.shape == (len(r), 2)
                 and bool(np.isfinite(p).all())
                 for (s, _), p, r in zip(answers, preds, reqs))
        t_cpu = time.perf_counter()
        ref = load_artifact(pub["artifact"], device="cpu").predict(reqs[0])
        cpu_s = time.perf_counter() - t_cpu
        err = float(np.abs(preds[0] - ref).max()) if ok else math.inf
        lat = sorted(b.get("latencyMs", 0.0) for _, b in answers)
        phase("long context predict", ok and err <= CPU_ATOL
              and launches["predict"]["flash_fwd"] == layers * dispatches,
              f"{LONG_PREDICTS} concurrent POST /serve/{name}/predict of "
              f"{[len(r) for r in reqs]} rows at T={LONG_STEP_T}: statuses "
              f"{sorted({s for s, _ in answers})}, {dispatches} dispatches, "
              f"K1 {launches['predict']['flash_fwd']} (want {layers} x "
              f"{dispatches}); the one-row request against the int8 "
              f"artifact on the CPU max|d| {err:.3g} (atol {CPU_ATOL}; CPU "
              f"{cpu_s:.1f}s)")
        line["predict"] = {"requests": LONG_PREDICTS, "wall_s": wall_s,
                           "dispatches": dispatches,
                           "latency_ms_p50": lat[len(lat) // 2],
                           "latency_ms_max": lat[-1],
                           "cpu_max_abs_err": err}
    finally:
        probe.close()
        server.shutdown()
    torch.cuda.empty_cache()
    return line, launches


def ring_step_kernels(attention) -> dict:
    """K1, K2 and K3 in bf16 at a ring step's shape, (2, 8, 32768, 32)
    non-causal with the timed shapes' key mask: each held against its
    plain version run in chunks of ``LONG_PLAIN_CHUNK`` query rows against
    every key (K2 and K3 on the kernel's own LSE and delta; K3's dK/dV
    partials summed over the chunks in f32): O, LSE, dQ, dK and dV within
    ``LONG_BF16_TOL`` of the plain values and of their largest magnitude;
    then timed beside their bounds and SDPA's forward and backward with
    the same mask, ``plain_ms`` the chunks' summed device time."""
    h = LONG_SHAPE["num_heads"]
    b, t, d = 2, LONG_FIT_T // LONG_SP, LONG_SHAPE["hidden_dim"] // h
    gen = torch.Generator(device=LONG_DEVICE).manual_seed(3)
    q, k, v, do = (torch.randn(b, h, t, d, device=LONG_DEVICE, generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))
    km = _timing_mask(b, t, q.device)

    def once(fn):
        out = []
        return out, time_ms(lambda: out.append(fn()), reps=1, warmup=0)

    with torch.inference_mode():
        o, lse = attention.flash_attention_fwd(q, k, v, km, False)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        bwd = (km, do, lse, delta, False)
        dq = attention.flash_attention_bwd_dq(q, k, v, *bwd)
        dk, dv = attention.flash_attention_bwd_dkv(q, k, v, *bwd)
        mine = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        err = dict.fromkeys(mine, 0.0)
        top = dict.fromkeys(mine, 0.0)
        plain_ms = {"k1": 0.0, "dq": 0.0, "dkv": 0.0}
        dk_ref = torch.zeros(dk.shape, device=q.device)
        dv_ref = torch.zeros(dv.shape, device=q.device)
        for i in range(0, t, LONG_PLAIN_CHUNK):
            rows = slice(i, i + LONG_PLAIN_CHUNK)
            qc, doc = q[:, :, rows], do[:, :, rows]
            cut = (km, doc, lse[:, :, rows], delta[:, :, rows], False)
            got, ms = once(lambda: attention.flash_attention_fwd_plain(
                qc, k, v, km, False))
            plain_ms["k1"] += ms
            got_dq, ms = once(lambda: attention.flash_attention_bwd_dq_plain(
                qc, k, v, *cut))
            plain_ms["dq"] += ms
            got_dkv, ms = once(
                lambda: attention.flash_attention_bwd_dkv_plain(qc, k, v,
                                                                *cut))
            plain_ms["dkv"] += ms
            dk_ref += got_dkv[0][0].float()
            dv_ref += got_dkv[0][1].float()
            for name, ref in (("o", got[0][0]), ("lse", got[0][1]),
                              ("dq", got_dq[0])):
                err[name] = max(err[name], max_abs(mine[name][:, :, rows],
                                                   ref))
                top[name] = max(top[name], float(ref.float().abs().max()))
            del got, got_dq, got_dkv
        for name, ref in (("dk", dk_ref), ("dv", dv_ref)):
            err[name] = max_abs(mine[name], ref)
            top[name] = float(ref.abs().max())
        finite = all(bool(torch.isfinite(x).all()) for x in mine.values())
        del mine, dk_ref, dv_ref, o, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    # LSE (~log T) by its absolute error alone; the others also against
    # their largest magnitude, which at T = 32,768 is far below 1.
    ok = finite and all(
        err[n] <= LONG_BF16_TOL
        and (n == "lse" or err[n] <= LONG_BF16_TOL * top[n]) for n in err)
    out = _time_bwd_at(attention, (q, k, v, None, do), plain=False, reps=5)
    for key, ms in plain_ms.items():
        out[key]["plain_ms"] = ms
    out["check"] = {"max_abs_err": err, "max_abs_ref": top,
                    "chunk_rows": LONG_PLAIN_CHUNK, "finite": finite}
    phase("long context ring step kernels", ok,
          f"K1/K2/K3 bf16 at a ring step's {tuple(q.shape)}, key mask "
          f"(last 37 keys), against their plain versions in "
          f"{t // LONG_PLAIN_CHUNK} chunks of {LONG_PLAIN_CHUNK} query rows"
          f": max|d| {err}, largest |plain| {top} (bar {LONG_BF16_TOL} "
          f"absolute and of the largest |plain|, LSE absolute only); "
          f"finite {finite}; plain ms {plain_ms}")
    return out


def run_long_context(tmp, card: str) -> dict:
    """Phase 18: long-context training over the sequence-parallel ring.
    (a) two gloo rank processes on cuda:0 (``--ring-child``) check the
    flash ring against the plain version and the f32 sp = 2 step against
    one device, while (c) drives the REST path (``/train/horovod`` with
    ``{"sp": 2}``, the int8 artifact, ``/predict``); then (b) the 4-step
    bf16 fit at T = 65,536 through ``DistributedTrainer``, and K1-K3
    checked and timed at a ring step's shape; the ``long_context``
    line."""
    from learningorchestra_tpu_torch.ops import attention

    t_phase = time.perf_counter()
    line: dict = {}
    stage = os.path.join(tmp, "ring")
    os.makedirs(stage)
    logs = [open(os.path.join(stage, f"rank{r}.log"), "wb")
            for r in range(LONG_SP)]
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ring-child", stage,
         str(r)], stdout=logs[r], stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL, env=env) for r in range(LONG_SP)]
    try:
        line["rest"], launches = long_rest(os.path.join(tmp, "rest"), card)
        line["ring"], line["f32_step"] = ring_results(procs, stage)
        line["fit"] = long_fit()
        launches["fit_ranks"] = [r["launches"] for r in line["fit"]["ranks"]]
        line["timing"] = ring_step_kernels(attention)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for fh in logs:
            fh.close()
    t = line["timing"]
    print(f"[info] long context kernels at {tuple(t['shape'])} bf16, "
          f"non-causal, key mask: K1 {t['k1']['ms']:.3f} ms "
          f"(bound {t['k1']['bound_ms']:.3f}), K2 {t['dq']['ms']:.3f} "
          f"(bound {t['dq']['bound_ms']:.3f}), K3 {t['dkv']['ms']:.3f} "
          f"(bound {t['dkv']['bound_ms']:.3f}); SDPA forward "
          f"{t['library_fwd_ms']:.3f}, backward {t['library_bwd_ms']:.3f}",
          flush=True)
    line["launches"] = launches
    line["phase_s"] = time.perf_counter() - t_phase
    name, _, limit = card.partition(",")
    line = {"card": name.strip(), "power_limit": limit.strip(), **line}
    return {"line": line, "launches": launches}


# -- phase 19: expert parallelism and data-parallel MoE training -------------

# MoETransformerClassifier at the JAX package's defaults
# (learningorchestra_tpu/models/moe.py:148, MOE_CLS_SHAPE) over dp 2 x ep 2:
# four gloo ranks on the one card, each holding 4 of the 8 experts and
# stepping on 16 rows of each global batch of 32 at T = 256.  MoEDecoderLM
# at its defaults (MOE_LM_SHAPE) over REST with {"ep": 2}.  Depth is not
# cut.
EP_MESH = {"dp": 2, "ep": 2}
EP_WORLD = 4
EP_DEVICE = "cuda:0"
EP_STEP_ROWS = 32  # (a): one f32 step of the global batch, T = 256
EP_LR = 0.1  # (a)'s SGD step, after which the replicas are compared
EP_LOSS_BAR = 1e-5  # (a): |objective - one device's|
EP_LEAF_BAR = 1e-3  # (a): each gradient leaf, of its largest entry
EP_FIT_ROWS, EP_FIT_BATCH, EP_FIT_EPOCHS = 128, 32, 2  # (b): 8 steps
EP_REST_ROWS, EP_REST_BATCH = 16, 8  # (c): 2 steps at T = 1024
EP_PROMPT_LENS = (48, 200)
EP_NEW = 8
EP_MODEL = "ep_lm"
EP_CHILD_TIMEOUT_S = 300
EP_BF16_TOL = 3e-2


def _split_bytes(shape: dict, ep: int) -> int:
    """Bytes of the f32 expert leaves a rank does not hold under ``ep``:
    (E - E/ep) experts of each MoE layer (the last of every 2 blocks)."""
    e, h = shape["num_experts"], shape["hidden_dim"]
    m = shape.get("mlp_dim") or 4 * h
    per_expert = 2 * h * m + m + h
    return 4 * (shape["num_layers"] // 2) * (e - e // ep) * per_expert


def ep_child(tmp: str, rank: int) -> int:
    """(a) of phase 19 in one of four gloo ranks on cuda:0 (``python3
    chip_smoke.py --ep-child DIR RANK``): the port's ``DataParallel`` lays
    dp 2 x ep 2; the classifier split over the rank's expert group loads
    its slice of the seeded state; one f32 step of its 16 rows of the
    global batch (the aux loss over the global batch, the gradients
    summed over the ranks holding each copy) against the same step of
    the whole batch on one device, then an SGD update and the replicated
    leaves compared bit for bit across the expert group.  Writes
    ``DIR/rank<r>.json``."""
    from pathlib import Path

    import torch.distributed as dist

    from learningorchestra_tpu_torch.models.moe import (
        MoETransformerClassifier,
    )
    from learningorchestra_tpu_torch.ops.moe import (
        AuxLosses,
        split_expert_parameters,
    )
    from learningorchestra_tpu_torch.parallel.distributed import (
        DataParallel,
        init_process_group,
    )

    stage = Path(tmp)
    dev = torch.device(EP_DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_process_group(stage, rank, EP_WORLD, "gloo")
    dp = DataParallel(rank, EP_WORLD, dev, "gloo", stage / "cancel",
                      ep=EP_MESH["ep"])
    x = moe_classifier_rows(EP_STEP_ROWS, seed=21)
    xt = torch.from_numpy(x).to(dev)
    yt = torch.from_numpy((x[:, 0] % 2).astype(np.int64)).to(dev)
    ones = torch.ones(EP_STEP_ROWS, device=dev)
    one = MoETransformerClassifier(**MOE_CLS_SHAPE, seed=0, device=dev)
    est = MoETransformerClassifier(**MOE_CLS_SHAPE, seed=0, device=dev)
    for e in (one, est):
        e.compute_dtype = "float32"
        e.compile(optimizer="sgd", learning_rate=EP_LR)
    split_layers = est.bind_experts(dp.ep_comm)
    est.load_state_dict(dp.local_experts(one.state_dict(), est.module))
    est._dp = dp
    est._reset_optimizer()
    split = {id(p) for p in split_expert_parameters(est.module)}
    loss_fn = est._loss_and_metrics("softmax_ce")
    rows = dp.rows(EP_STEP_ROWS)
    zero_kernel_counts()
    aux = AuxLosses(dp.replicas)
    logits = est.module(xt[rows], aux_losses=aux).float()
    ce, _ = loss_fn(logits, yt[rows], ones[rows], ones.sum())
    (ce + sum(aux)).backward()
    dp.sync_grads(est.module)
    counts = kernel_counts()
    total = float(dp.replicas.all_reduce(ce.detach().reshape(1))[0]
                  + sum(aux).detach())
    aux1: list = []
    ce1, _ = loss_fn(one.module(xt, aux_losses=aux1).float(), yt, ones)
    (ce1 + sum(aux1)).backward()
    ref = dict(one.module.named_parameters())
    lo = dp.ep_index * (MOE_CLS_SHAPE["num_experts"] // EP_MESH["ep"])
    worst, worst_name, n_split = 0.0, None, 0
    for name, p in est.module.named_parameters():
        want = ref[name].grad
        if id(p) in split:
            want = want[lo:lo + p.shape[0]]
            n_split += 1
        rel = float((p.grad - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        if rel >= worst:
            worst, worst_name = rel, name
    est.opt_state.step()
    unequal = []
    for name, p in est.module.named_parameters():
        if id(p) in split:
            continue
        both = dp.ep_comm.all_gather(p.detach()[None], timed=False)
        if not torch.equal(both[0], both[1]):
            unequal.append(name)
    out = {"rank": rank, "dp_index": dp.dp_index, "ep_index": dp.ep_index,
           "objective": total, "objective_one": float(ce1 + sum(aux1)),
           "aux": [float(a) for a in aux], "aux_one": [float(a)
                                                      for a in aux1],
           "max_leaf_rel": worst, "worst_leaf": worst_name,
           "split_layers": split_layers, "split_leaves": n_split,
           "replicated_unequal": unequal, "launches": counts,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in est.module.parameters()),
           "param_bytes_one": sum(p.numel() * p.element_size()
                                  for p in one.module.parameters())}
    with open(stage / f"rank{rank}.json", "w") as fh:
        json.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def ep_results(procs: list, stage: str) -> dict:
    """(a): wait for the children (bounded), read their results, print
    the f32 step's phase line."""
    deadline = time.monotonic() + EP_CHILD_TIMEOUT_S
    for proc in procs:
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    res = []
    for r, proc in enumerate(procs):
        path = os.path.join(stage, f"rank{r}.json")
        if proc.returncode != 0 or not os.path.exists(path):
            with open(os.path.join(stage, f"rank{r}.log"), "rb") as fh:
                tail = fh.read()[-3000:].decode(errors="replace")
            raise RuntimeError(f"ep child {r} exited {proc.returncode}:"
                               f"\n{tail}")
        with open(path) as fh:
            res.append(json.load(fh))
    layers = MOE_CLS_SHAPE["num_layers"]
    d_loss = max(abs(c["objective"] - c["objective_one"]) for c in res)
    worst = max(c["max_leaf_rel"] for c in res)
    dropped = _split_bytes(MOE_CLS_SHAPE, EP_MESH["ep"])
    ok = d_loss <= EP_LOSS_BAR and worst <= EP_LEAF_BAR and all(
        not c["replicated_unequal"] and c["split_leaves"] == 4
        and c["param_bytes"] == c["param_bytes_one"] - dropped
        and all(c["launches"][k] == layers for k in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")) for c in res) \
        and [(c["dp_index"], c["ep_index"]) for c in res] == [
            (r // 2, r % 2) for r in range(EP_WORLD)]
    phase("expert parallel f32 step", ok,
          f"MoETransformerClassifier({MOE_CLS_SHAPE}) f32 over dp 2 x ep 2 "
          f"(4 gloo ranks on {EP_DEVICE}, 16 rows of {EP_STEP_ROWS} at "
          f"T={MOE_CLS_SHAPE['max_len']} each, "
          f"{MOE_CLS_SHAPE['num_experts'] // EP_MESH['ep']} of "
          f"{MOE_CLS_SHAPE['num_experts']} experts): objective "
          f"(CE summed over the replicas + the global-batch aux loss) "
          f"{res[0]['objective']:.8f}, one device "
          f"{res[0]['objective_one']:.8f}, max |d| {d_loss:.3g} (bar "
          f"{EP_LOSS_BAR}); aux {res[0]['aux']} vs {res[0]['aux_one']}; "
          f"largest gradient-leaf difference / its largest entry {worst:.3g}"
          f" (bar {EP_LEAF_BAR}; worst {[c['worst_leaf'] for c in res]}); "
          f"after an SGD step the replicated leaves unequal across each "
          f"expert group: {[c['replicated_unequal'] for c in res]}; "
          f"parameter bytes a rank {res[0]['param_bytes']} vs one device "
          f"{res[0]['param_bytes_one']} (want {dropped} fewer); K1/K2/K3 "
          f"per rank {[[c['launches'][k] for k in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')] for c in res]}"
          f" (want {layers} each)")
    return {"objective_abs_diff": d_loss, "max_leaf_rel": worst,
            "ranks": res}


def ep_step_kernels(attention) -> dict:
    """K1, K2 and K3 in bf16 at a rank's attention shape in (b), (16, 4,
    256, 32) with the timed shapes' key mask, each against its plain
    version on the same inputs (bar ``EP_BF16_TOL``)."""
    h = MOE_CLS_SHAPE["num_heads"]
    b, t = EP_FIT_BATCH // EP_MESH["dp"], MOE_CLS_SHAPE["max_len"]
    d = MOE_CLS_SHAPE["hidden_dim"] // h
    gen = torch.Generator(device=EP_DEVICE).manual_seed(19)
    q, k, v, do = (torch.randn(b, h, t, d, device=EP_DEVICE, generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))
    km = _timing_mask(b, t, q.device)
    with torch.inference_mode():
        o, lse = attention.flash_attention_fwd(q, k, v, km, False)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        bwd = (km, do, lse, delta, False)
        dq = attention.flash_attention_bwd_dq(q, k, v, *bwd)
        dk, dv = attention.flash_attention_bwd_dkv(q, k, v, *bwd)
        o_ref, lse_ref = attention.flash_attention_fwd_plain(q, k, v, km,
                                                             False)
        dq_ref = attention.flash_attention_bwd_dq_plain(q, k, v, *bwd)
        dk_ref, dv_ref = attention.flash_attention_bwd_dkv_plain(q, k, v,
                                                                 *bwd)
    err = {"o": max_abs(o, o_ref), "lse": max_abs(lse, lse_ref),
           "dq": max_abs(dq, dq_ref), "dk": max_abs(dk, dk_ref),
           "dv": max_abs(dv, dv_ref)}
    ok = all(v <= EP_BF16_TOL for v in err.values())
    phase("expert parallel step kernels", ok,
          f"K1/K2/K3 bf16 at a rank's {tuple(q.shape)} with a key mask "
          f"(last 37 keys) against their plain versions: max|d| {err} "
          f"(bar {EP_BF16_TOL})")
    return {"shape": list(q.shape), "max_abs_err": err}


def ep_fit() -> dict:
    """(b): ``DistributedTrainer(spec=MeshSpec(dp=2, ep=2))`` over four
    gloo ranks on cuda:0 fits the classifier 8 bf16 steps of 32 rows at
    T = 256."""
    from learningorchestra_tpu_torch.models.moe import (
        MoETransformerClassifier,
    )
    from learningorchestra_tpu_torch.parallel import (
        DistributedTrainer,
        MeshSpec,
    )

    est = MoETransformerClassifier(**MOE_CLS_SHAPE, seed=0, device=EP_DEVICE)
    x = moe_classifier_rows(EP_FIT_ROWS, seed=23)
    y = (x[:, 0] % 2).astype(np.int32)
    trainer = DistributedTrainer(est, spec=MeshSpec(**EP_MESH),
                                 devices=[EP_DEVICE] * EP_WORLD)
    t0 = time.perf_counter()
    trainer.fit(x, y, epochs=EP_FIT_EPOCHS, batch_size=EP_FIT_BATCH,
                shuffle=False)
    fit_s = time.perf_counter() - t0
    steps = EP_FIT_EPOCHS * EP_FIT_ROWS // EP_FIT_BATCH
    layers = MOE_CLS_SHAPE["num_layers"]
    full = sum(p.numel() * p.element_size() for p in est.module.parameters())
    dropped = _split_bytes(MOE_CLS_SHAPE, EP_MESH["ep"])

    def median(v):
        return float(np.median(v[1:] or v)) if v else None

    ranks = [{"rank": s["rank"], "dp_index": s["dp_index"],
              "ep_index": s["ep_index"],
              "step_ms": s["step_ms"], "step_ms_p50": median(s["step_ms"]),
              "sync_ms_p50": median(s["sync_ms"]),
              "ep_exchange_ms_per_step": sum(s["ep_ms"]) / steps,
              "ep_collectives": len(s["ep_ms"]),
              "peak_mib": s.get("peak_memory_bytes", 0) / 2**20,
              "param_bytes": s["param_bytes"],
              "launches_per_step": {k: s["launches"][k] / steps for k in (
                  "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
              "launches": s["launches"],
              "spawn_to_first_step_s": s["spawn_to_first_step_s"]}
             for s in trainer.rank_stats]
    losses = list(trainer.history["loss"])
    ok = trainer.backend == "gloo" and len(ranks) == EP_WORLD and all(
        len(r["step_ms"]) == steps and r["ep_collectives"] == 2 * steps
        and r["param_bytes"] == full - dropped
        and all(v == layers for v in r["launches_per_step"].values())
        for r in ranks) and len(losses) == EP_FIT_EPOCHS and all(
        math.isfinite(v) for v in losses)
    phase("expert parallel fit", ok,
          f"DistributedTrainer(MoETransformerClassifier(), MeshSpec(dp=2, "
          f"ep=2), devices=['{EP_DEVICE}'] x 4, {trainer.backend}): {steps} "
          f"bf16 steps of {EP_FIT_BATCH} rows at T="
          f"{MOE_CLS_SHAPE['max_len']}: losses {losses}; per rank step ms "
          f"p50 {[round(r['step_ms_p50'], 2) for r in ranks]}, gradient "
          f"sync p50 {[round(r['sync_ms_p50'], 2) for r in ranks]}, expert "
          f"exchange per step "
          f"{[round(r['ep_exchange_ms_per_step'], 2) for r in ranks]} "
          f"({2 * steps} collectives each), peak memory "
          f"{[round(r['peak_mib'], 1) for r in ranks]} MiB, parameter bytes "
          f"{[r['param_bytes'] for r in ranks]} (one device {full}, want "
          f"{dropped} fewer); K1/K2/K3 per step "
          f"{[list(r['launches_per_step'].values()) for r in ranks]} (want "
          f"{layers} each); fit {fit_s:.1f}s")
    return {"losses": losses, "fit_s": fit_s, "ranks": ranks,
            "param_bytes_one_device": full}


def ep_rest(tmp, card: str) -> tuple:
    """(c): the port's server with two lease units of cuda:0: MoEDecoderLM
    created over REST at its defaults, ``POST /train/horovod`` with
    ``"mesh": {"ep": 2}`` (2 steps of 8 rows at T = 1024), the trained
    model published int8 (K4, all 8 experts of each layer) and loaded
    (K5), then ``/generate`` of 8 tokens for two prompts against a
    one-device greedy decode of the same artifact."""
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.jobs.leases import DeviceLeaser
    from learningorchestra_tpu_torch.ops.moe import EXPERT_LEAVES
    from learningorchestra_tpu_torch.store.volumes import VolumeStorage
    from learningorchestra_tpu_torch.train.neural import load_artifact

    line: dict = {}
    launches: dict = {}
    layers = MOE_LM_SHAPE["num_layers"]
    volumes = VolumeStorage(tmp)
    server = APIServer(server_config(tmp), device=EP_DEVICE)
    port = server.start_background()
    server.ctx.leaser = server.ctx.engine.leaser = DeviceLeaser(
        [EP_DEVICE] * EP_MESH["ep"])
    probe = TrainerProbe()
    try:
        status, meta, model_s, _ = rest_job(
            port, "POST", "/model/tensorflow",
            {"name": EP_MODEL, "modulePath": MOE_PATH,
             "class": "MoEDecoderLM", "classParameters": {"seed": 0}},
            EP_MODEL)
        phase("expert parallel model", status == 201
              and bool(meta.get("finished")),
              f"POST /model/tensorflow {MOE_PATH}.MoEDecoderLM -> {status}, "
              f"finished {meta.get('finished')} in {model_s:.2f}s")
        x = moe_rows(EP_REST_ROWS, MOE_LM_SHAPE["max_len"], seed=29)
        y = np.concatenate([x[:, 1:], np.zeros((len(x), 1), np.int32)], 1)
        fit_name = f"{EP_MODEL}_fit"
        status, meta, fit_s, parent = rest_job(
            port, "POST", "/train/horovod",
            {"name": fit_name, "parentName": EP_MODEL,
             "trainingParameters": {"x": x.tolist(), "y": y.tolist(),
                                    "epochs": 1,
                                    "batch_size": EP_REST_BATCH,
                                    "shuffle": False},
             "mesh": {"ep": EP_MESH["ep"]}}, fit_name)
        fit = probe.fits[-1] if probe.fits else {"rank_stats": [],
                                                 "world": 0}
        steps = EP_REST_ROWS // EP_REST_BATCH
        want = layers * steps
        ranks = [s["launches"] for s in fit["rank_stats"]]
        launches["rest_ranks"] = ranks
        _, rows = request(port, "GET", f"/train/horovod/{fit_name}")
        history = [r.get("loss") for r in rows
                   if r.get("docType") == "history"]
        trained = server.ctx.volumes.load_estimator(
            "train/tensorflow", fit_name, device=EP_DEVICE)
        experts = {
            f"{name}.{key}": getattr(mod, key).shape[0]
            for name, mod in trained.module.named_modules()
            if hasattr(mod, "expert_w1") for key in EXPERT_LEAVES}
        dropped = _split_bytes(MOE_LM_SHAPE, EP_MESH["ep"])
        full = sum(p.numel() * p.element_size()
                   for p in trained.module.parameters())
        phase("expert parallel rest fit", status == 201
              and bool(meta.get("finished")) and fit["world"] == 2
              and meta.get("mesh") == {"ep": EP_MESH["ep"]}
              and len(history) == 1 and all(math.isfinite(v)
                                            for v in history)
              and len(ranks) == 2 and all(
                  r[k] == want for r in ranks for k in (
                      "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
              and experts and all(
                  v == MOE_LM_SHAPE["num_experts"] for v in experts.values())
              and all(s["param_bytes"] == full - dropped
                      for s in fit["rank_stats"]),
              f"POST /train/horovod mesh {{'ep': {EP_MESH['ep']}}}, "
              f"{EP_REST_ROWS} rows at T={MOE_LM_SHAPE['max_len']}, batch "
              f"{EP_REST_BATCH}: {meta.get('jobState')} in {fit_s:.2f}s "
              f"(fitTime {meta.get('fitTime')}), world {fit['world']}, loss "
              f"{history}; K1/K2/K3 per rank "
              f"{[[r[k] for k in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')] for r in ranks]}"
              f" (want {want}); the trained artifact's experts per leaf "
              f"{sorted(set(experts.values()))} (want "
              f"{MOE_LM_SHAPE['num_experts']}); parameter bytes per rank "
              f"{[s['param_bytes'] for s in fit['rank_stats']]} (one device "
              f"{full}), parent {parent}")
        line["fit"] = {"job_s": fit_s, "fit_time_s": meta.get("fitTime"),
                       "losses": history, "rank_stats": [
                           {"rank": s["rank"], "step_ms": s["step_ms"],
                            "sync_ms": s["sync_ms"],
                            "ep_exchange_ms": sum(s["ep_ms"]),
                            "peak_mib": s.get("peak_memory_bytes", 0)
                            / 2**20, "param_bytes": s["param_bytes"],
                            "spawn_to_first_step_s":
                            s["spawn_to_first_step_s"]}
                           for s in fit["rank_stats"]]}
        pub = moe_publish(server, port, volumes, trained, EP_MODEL)
        launches["publish"], launches["load"] = pub["k4"], pub["k5"]
        line["artifact"] = {k: pub[k] for k in (
            "save_s", "load_s", "int8_leaves", "f32_leaves",
            "expert_leaves", "int8_expert_leaves")}
        prompts = [moe_rows(1, n, seed=60 + i)[0].tolist()
                   for i, n in enumerate(EP_PROMPT_LENS)]
        zero_kernel_counts()
        t0 = time.perf_counter()
        status, body = request(port, "POST", f"/serve/{EP_MODEL}/generate",
                               {"prompts": prompts, "maxNewTokens": EP_NEW})
        gen_s = time.perf_counter() - t0
        launches["generate"] = kernel_counts()
        toks = body.get("tokens", [])
        solo_est = load_artifact(pub["artifact"], device=EP_DEVICE)
        solo = [solo_est.generate(np.asarray([p], np.int32),
                                  max_new_tokens=EP_NEW)[0].tolist()
                for p in prompts]
        del solo_est
        phase("expert parallel generate", status == 200 and toks == solo
              and all(len(t) == len(p) + EP_NEW for t, p in zip(toks,
                                                                prompts)),
              f"POST /serve/{EP_MODEL}/generate of prompts "
              f"{list(EP_PROMPT_LENS)} tokens, {EP_NEW} new each, from the "
              f"int8 artifact of the {{'ep': 2}} fit -> {status} in "
              f"{gen_s:.2f}s; equal to a one-device greedy decode of the "
              f"same artifact: {toks == solo}; K1 "
              f"{launches['generate']['flash_fwd']}")
        line["generate"] = {"prompts": list(EP_PROMPT_LENS),
                            "new_tokens": EP_NEW, "s": gen_s,
                            "equal_to_one_device": toks == solo}
    finally:
        probe.close()
        server.shutdown()
    torch.cuda.empty_cache()
    return line, launches


def run_expert_parallel(tmp, card: str) -> dict:
    """Phase 19: expert parallelism and the data-parallel MoE fit.  (a)
    four gloo rank processes on cuda:0 (``--ep-child``) check one f32
    dp 2 x ep 2 step against one device while (c) drives the REST path
    (``/train/horovod`` with ``{"ep": 2}`` on the decoder LM, the int8
    artifact, ``/generate``); then (b) the 8-step bf16 fit of the
    classifier through ``DistributedTrainer`` and K1-K3 checked at a
    rank's attention shape; the ``expert_parallel`` line."""
    from learningorchestra_tpu_torch.ops import attention

    t_phase = time.perf_counter()
    line: dict = {}
    stage = os.path.join(tmp, "ep")
    os.makedirs(stage)
    logs = [open(os.path.join(stage, f"rank{r}.log"), "wb")
            for r in range(EP_WORLD)]
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ep-child", stage,
         str(r)], stdout=logs[r], stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL, env=env) for r in range(EP_WORLD)]
    try:
        line["rest"], launches = ep_rest(os.path.join(tmp, "rest"), card)
        line["f32_step"] = ep_results(procs, stage)
        line["fit"] = ep_fit()
        launches["fit_ranks"] = [r["launches"] for r in line["fit"]["ranks"]]
        line["kernels"] = ep_step_kernels(attention)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for fh in logs:
            fh.close()
    line["launches"] = launches
    line["phase_s"] = time.perf_counter() - t_phase
    name, _, limit = card.partition(",")
    line = {"card": name.strip(), "power_limit": limit.strip(), **line}
    return {"line": line, "launches": launches}


def convert_tree(est):
    from learningorchestra_tpu_torch import convert

    return convert.flax_tree(est.module)


# -- phase 20: the operations plane ------------------------------------------

OPS_ROWS = 96  # 3 steps of 32 a epoch at T=128
OPS_EPOCHS = 3
OPS_PREDICTS = 24
# Phase 20 (e): a predict-latency objective over a fast rollup clock.
OPS_TICK_S = 0.25
OPS_FAST_S, OPS_SLOW_S = 2.0, 4.0
OPS_THRESHOLD_MS = 300.0
OPS_DELAY_MS = 700.0
OPS_LOSS_RTOL = 1e-5
# A finished job's allocations are freed: what stays allocated after it
# is the cached programs' and the resident models' (none new here).
OPS_MEM_SLACK = 64 << 20
_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$")
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_PROM_ESCAPE = re.compile(r"\\(.)")


def parse_prom(text: str) -> dict:
    """Prometheus text 0.0.4 -> {(name, frozenset(labels)): value}."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            raise ValueError(f"not a sample line: {line!r}")
        labels = frozenset(
            (k, _PROM_ESCAPE.sub(
                lambda e: "\n" if e.group(1) == "n" else e.group(1), v))
            for k, v in _PROM_LABEL.findall(m.group(3) or ""))
        out[(m.group(1), labels)] = float(m.group(4))
    return out


def prom_sum(samples: dict, name: str, **labels) -> float:
    """The sum of a family's samples whose labels include ``labels``."""
    want = set(labels.items())
    return sum(v for (n, ls), v in samples.items()
               if n == name and want <= set(ls))


def decode_registry(model: str) -> dict:
    """The process registry's decode token count and TTFT observations
    for ``model`` (the families /metrics.prom exposes)."""
    from learningorchestra_tpu_torch.obs.metrics import get_registry
    from learningorchestra_tpu_torch.serve.decode.engine import (
        DECODE_TOKENS,
        DECODE_TTFT,
    )

    samples = parse_prom(get_registry().render_prometheus())
    return {"tokens": prom_sum(samples, DECODE_TOKENS, model=model),
            "ttft_count": prom_sum(samples, DECODE_TTFT + "_count",
                                   model=model)}


def rid_request(port, verb, path, body=None, rid=None):
    """``request`` with an ``X-Request-Id``: -> (status, JSON or text,
    the echoed request id)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["X-Request-Id"] = rid
    try:
        conn.request(verb, "/api/learningOrchestra/v1" + path,
                     body=None if body is None else json.dumps(body),
                     headers=headers)
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type", "")
        doc = json.loads(raw) if "json" in ctype else raw.decode()
        return resp.status, doc, resp.getheader("X-Request-Id")
    finally:
        conn.close()


def disabled_costs() -> dict:
    """ns per call of the fault plane's ``hit`` with nothing armed and of
    a ``span`` with no active trace, in this process."""
    from learningorchestra_tpu_torch import faults
    from learningorchestra_tpu_torch.obs import tracing

    n = 200_000
    hit = faults.hit
    t0 = time.perf_counter_ns()
    for _ in range(n):
        hit("serve.apply")
    hit_ns = (time.perf_counter_ns() - t0) / n
    span = tracing.span
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("x"):
            pass
    span_ns = (time.perf_counter_ns() - t0) / n
    return {"fault_hit_ns": hit_ns, "span_ns": span_ns, "calls": n}


def run_operations_plane(tmp, card: str, dec_line: dict) -> dict:
    """Phase 20 on the card: (a) a BERT-base REST train job preempted by
    an armed ``train.epoch`` fault resumes from its checkpoint on the
    engine's retry (K1-K3 counts show no restart), equal to its unfaulted
    twin; its int8 artifact served (K4, K5); (b) its span tree under the
    submit's ``X-Request-Id``; (c) ``/metrics.prom`` deltas against what
    the phase did, and phase 13's decode deltas against its streams; (d)
    ``serve.apply`` armed to fail once under 24 predicts; (e) a
    predict-latency objective fired by a ``serve.apply`` delay, one
    bundle, then resolved; (f) the disabled costs and a predict p50."""
    import gc

    from learningorchestra_tpu_torch import faults
    from learningorchestra_tpu_torch.api.server import APIServer
    from learningorchestra_tpu_torch.config import (
        BundleConfig,
        RollupConfig,
        SLOConfig,
    )
    from learningorchestra_tpu_torch.obs import bundle, rollup, slo
    from learningorchestra_tpu_torch.serve.service import PREDICT_DURATION

    t_phase = time.perf_counter()
    line: dict = {"card": card}
    launches: dict = {}
    x, _ = make_train_data(30522)
    x = x[:OPS_ROWS]
    csv = f"{tmp}/ops_tokens.csv"
    _, y = make_train_data(30522)
    with open(csv, "w") as fh:
        fh.write(",".join(REST_FIELDS + ["label"]) + "\n")
        for row, label in zip(x, y[:OPS_ROWS]):
            fh.write(",".join(map(str, row)) + f",{label}\n")
    # The phase's own clocks: a fast rollup tick, SLO windows of seconds
    # and only the runtime objective (e) adds; a bundle store of its own.
    rollup.reset_engine(RollupConfig(tick_s=OPS_TICK_S, points=256))
    slo.reset_service(SLOConfig(
        availability_target=0.0, predict_p99_ms=0.0, job_success_target=0.0,
        fast_window_s=OPS_FAST_S, slow_window_s=OPS_SLOW_S,
        burn_threshold=2.0, for_s=0.5, resolve_s=1.0))
    bundle.reset_service()
    cfg = server_config(f"{tmp}/volumes")
    cfg.bundle = BundleConfig(dir=f"{tmp}/bundles", debounce_s=300.0)
    cfg.jobs.retry_backoff_s = 0.05
    server = APIServer(cfg, device="cuda")
    port = server.start_background()
    steps = OPS_EPOCHS * (OPS_ROWS // TRAIN_SHAPE[0])
    fit = {"x": "$ops_x", "y": "$ops.label", "epochs": OPS_EPOCHS,
           "batch_size": TRAIN_SHAPE[0], "shuffle": False,
           "checkpoint_every": 1, "checkpoint_min_interval_s": 0,
           "checkpoint_async": False, "quantize_checkpoint": True}
    per_job = {"flash_fwd": REST_LAYERS * steps,
               "flash_bwd_dq": REST_LAYERS * steps,
               "flash_bwd_dkv": REST_LAYERS * steps,
               "quantize_rowwise": 1, "dequantize_rowwise": 0}
    try:
        status, text, _ = rid_request(port, "GET", "/metrics.prom")
        prom0 = parse_prom(text)
        jobs_run = 0
        for key, path, body, name in (
                ("ingest", "/dataset/csv",
                 {"datasetName": "ops", "url": f"file://{csv}"}, "ops"),
                ("projection", "/transform/projection",
                 {"projectionName": "ops_x", "datasetName": "ops",
                  "fields": REST_FIELDS}, "ops_x"),
                ("model", "/model/tensorflow",
                 {"modelName": "ops_bert", "class": "BertModel",
                  "modulePath": "learningorchestra_tpu.models.text",
                  "classParameters": REST_MODEL}, "ops_bert")):
            st, meta, secs, _ = rest_job(port, "POST", path, body, name)
            jobs_run += 1
            phase(f"ops job {key}", st == 201
                  and meta.get("jobState") == "finished",
                  f"POST {path} -> {st}, {meta.get('jobState')} in "
                  f"{secs:.2f}s")

        # (a) the preempted fit and its unfaulted twin.
        gc.collect()
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        faults.arm("train.epoch", "preempt", after=2, max_triggers=1)
        zero_kernel_counts()
        t0 = time.perf_counter()
        st, created, echoed = rid_request(
            port, "POST", "/train/tensorflow",
            {"name": "ops_fit", "parentName": "ops_bert", "method": "fit",
             "methodParameters": fit}, rid="ops-fit-1")
        meta = wait_done(port, "ops_fit") if st == 201 else created
        fit_s = time.perf_counter() - t0
        launches["fit"] = kernel_counts()
        jobs_run += 1
        faults.disarm("train.epoch")
        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        # What stays: each thread that ran a GEMM keeps its cuBLAS
        # workspace in the caching allocator (the job ran on a new one).
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        mem_cleared = torch.cuda.memory_allocated()
        history = server.ctx.artifacts.ledger.history("ops_fit")
        states = [h["state"] for h in history]
        leases = [rec for rec in server.ctx.leaser.snapshot()["recent"]
                  if rec[0] == "ops_fit"]
        line["preempt"] = {
            "seconds": fit_s, "preemptions": meta.get("preemptions"),
            "ledger_states": states, "launches": launches["fit"],
            "expected": per_job, "memory_before": mem_before,
            "memory_after": mem_after,
            "memory_after_cublas_workspaces_cleared": mem_cleared,
            "leases": [(r[2], r[3]) for r in leases]}
        phase("ops preempted fit resumes",
              st == 201 and echoed == "ops-fit-1"
              and meta.get("jobState") == "finished"
              and meta.get("preemptions") == 1
              and states.count("preempted") == 1 and states[-1] == "finished"
              and faults.triggers("train.epoch") == 1
              and launches["fit"] == per_job,
              f"train.epoch preempt after=2 max=1 -> {meta.get('jobState')}"
              f" in {fit_s:.2f}s, preemptions {meta.get('preemptions')}, "
              f"ledger {states}; launches {launches['fit']} (want "
              f"{per_job}: epochs 0-2 once, {steps} steps; a restart "
              f"would add {REST_LAYERS * 2 * (OPS_ROWS // 32)} to K1-K3)")
        phase("ops preempted attempt freed its lease and memory",
              len(leases) == 2 and leases[0][3] <= leases[1][2]
              and mem_after - mem_before <= OPS_MEM_SLACK,
              f"leases of the job (start, end) {line['preempt']['leases']} "
              f"(two, the first released before the second); "
              f"memory_allocated {mem_before} -> {mem_after} bytes "
              f"(slack {OPS_MEM_SLACK}; {mem_cleared} with the cuBLAS "
              f"workspaces cleared)")
        st, meta2, secs2, twin_counts = rest_job(
            port, "POST", "/train/tensorflow",
            {"name": "ops_twin", "parentName": "ops_bert", "method": "fit",
             "methodParameters": fit}, "ops_twin")
        jobs_run += 1
        launches["twin"] = twin_counts
        line["preempt"]["twin_seconds"] = secs2

        def losses(name):
            rows = server.ctx.documents.find(
                name, query={"docType": "history"})
            return [r["loss"] for r in sorted(rows, key=lambda r: r["epoch"])]

        got, want = losses("ops_fit"), losses("ops_twin")
        rel = max((abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(got, want)), default=float("inf"))
        line["preempt"]["losses"] = got
        line["preempt"]["twin_losses"] = want
        line["preempt"]["loss_rel_err"] = rel
        phase("ops preempted fit equals its twin",
              meta2.get("jobState") == "finished"
              and len(got) == len(want) == OPS_EPOCHS
              and rel <= OPS_LOSS_RTOL and twin_counts == per_job,
              f"losses {got} vs unfaulted {want}: max relative "
              f"{rel:.3g} (bar {OPS_LOSS_RTOL}); twin launches "
              f"{twin_counts}")

        # (b) the span tree under the submit's request id.
        st, trace, _ = rid_request(
            port, "GET", "/observability/jobs/ops_fit/trace")
        spans = trace.get("spans", []) if st == 200 else []
        by_id = {s["id"]: s for s in spans}

        def attempt_of(span):
            while span is not None:
                if span["name"] == "job":
                    return span["attrs"]["attempt"]
                span = by_id.get(span.get("parent"))
            return None

        names = [s["name"] for s in spans]
        epochs: dict = {}
        for s in spans:
            if s["name"] == "epoch":
                epochs.setdefault(attempt_of(s), []).append(
                    s["attrs"]["epoch"])
        roots = [n["name"] for n in trace.get("tree", [])]
        line["trace"] = {"roots": roots, "spans": len(spans),
                         "epochs_by_attempt": epochs,
                         "requestId": trace.get("requestId")}
        phase("ops trace", st == 200 and trace.get("requestId") == "ops-fit-1"
              and names.count("queue_wait") == 1
              and names.count("lease") == 2
              and [s["attrs"]["attempt"] for s in spans
                   if s["name"] == "job"] == [1, 2]
              and epochs == {1: [0, 1], 2: [2]},
              f"GET /observability/jobs/ops_fit/trace -> {st}: requestId "
              f"{trace.get('requestId')}, roots {roots}, {len(spans)} spans "
              f"(queue_wait {names.count('queue_wait')}, lease "
              f"{names.count('lease')}, job {names.count('job')}, "
              f"retry_backoff {names.count('retry_backoff')}), epochs by "
              f"attempt {epochs}")

        # (d) serve the int8 artifact; serve.apply fails one dispatch.
        zero_kernel_counts()
        st, body, _ = rid_request(port, "POST", "/serve/ops_fit/load")
        launches["load"] = kernel_counts()
        phase("ops serve load", st == 200
              and launches["load"]["dequantize_rowwise"] == 1,
              f"POST /serve/ops_fit/load -> {st}; K5 "
              f"{launches['load']['dequantize_rowwise']} launch")
        # The model's batcher starts at its first predict.
        stats0 = server.serving.stats()["models"].get(
            "ops_fit", {"batches": 0, "rows": 0})
        st, _, _ = rid_request(port, "POST", "/faults/serve.apply",
                               {"mode": "error", "maxTriggers": 1})
        zero_kernel_counts()
        with concurrent.futures.ThreadPoolExecutor(OPS_PREDICTS) as pool:
            answers = list(pool.map(
                lambda i: rid_request(
                    port, "POST", "/serve/ops_fit/predict",
                    {"instances": x[i:i + 1].tolist()}, rid=f"ops-d-{i}"),
                range(OPS_PREDICTS)))
        launches["serve"] = kernel_counts()
        rid_request(port, "DELETE", "/faults")
        stats1 = server.serving.stats()["models"]["ops_fit"]
        ok_rows = [i for i, a in enumerate(answers) if a[0] == 200]
        failed = [i for i, a in enumerate(answers) if a[0] == 500]
        dispatches = stats1["batches"] - stats0["batches"]
        served_rows = stats1["rows"] - stats0["rows"]
        picks = ok_rows[:4]
        ref = server.ctx.volumes.load_estimator(
            "train/tensorflow", "ops_fit", device="cpu").predict(x[picks])
        got_p = np.concatenate([np.asarray(answers[i][1]["predictions"],
                                           np.float32) for i in picks])
        err = float(np.abs(got_p - ref).max()) if picks else float("inf")
        live = rid_request(port, "GET", "/health")[0] == 200 and \
            rid_request(port, "POST", "/serve/ops_fit/predict",
                        {"instances": x[:1].tolist()})[0] == 200
        line["serve_fault"] = {
            "answered": len(ok_rows), "failed": len(failed),
            "dispatches": dispatches, "served_rows": served_rows,
            "launches": launches["serve"], "cpu_max_abs_err": err,
            "latency_ms_p50": float(np.median(
                [answers[i][1]["latencyMs"] for i in ok_rows]))
            if ok_rows else None}
        phase("ops serve.apply fault",
              faults.triggers("serve.apply") == 1 and len(failed) >= 1
              and len(ok_rows) + len(failed) == OPS_PREDICTS
              and served_rows == len(ok_rows)
              and launches["serve"]["flash_fwd"] == REST_LAYERS * dispatches
              and err <= CPU_ATOL and live,
              f"{OPS_PREDICTS} one-row predicts under serve.apply error "
              f"max=1: {len(ok_rows)} answered 200, {len(failed)} failed "
              f"(one dispatch's requests; {served_rows} rows served in "
              f"{dispatches} dispatches); K1 {launches['serve']['flash_fwd']}"
              f" (want 12 x {dispatches}); rows {picks} vs the CPU plain "
              f"path max|dlogit| {err:.3g} (atol {CPU_ATOL}); live after: "
              f"{live}")

        # (c) the exposition's deltas against what the phase did.
        predict_route = next(
            key for *_, key in server.router.routes
            if key.startswith("POST /serve/") and key.endswith("/predict"))
        st, text, _ = rid_request(port, "GET", "/metrics.prom")
        prom1 = parse_prom(text)

        def delta(name, **labels):
            return prom_sum(prom1, name, **labels) - prom_sum(
                prom0, name, **labels)

        deltas = {
            "train_epoch_preempt": delta("lo_fault_triggers_total",
                                         point="train.epoch",
                                         mode="preempt"),
            "serve_apply_error": delta("lo_fault_triggers_total",
                                       point="serve.apply", mode="error"),
            "jobs_finished": delta("lo_jobs_total", state="finished"),
            "jobs_preempted": delta("lo_jobs_total", state="preempted"),
            "predicts_answered": delta(PREDICT_DURATION + "_count",
                                       model="ops_fit"),
            "predict_5xx": delta("lo_http_requests_total",
                                 route=predict_route, status="5xx"),
        }
        want_d = {"train_epoch_preempt": 1, "serve_apply_error": 1,
                  "jobs_finished": jobs_run, "jobs_preempted": 1,
                  "predicts_answered": len(ok_rows) + 1,
                  "predict_5xx": len(failed)}
        sse = dec_line.get("registry_sse", {})
        line["metrics"] = {"deltas": deltas, "want": want_d,
                           "decoder_sse": sse, "bytes": len(text)}
        phase("ops metrics deltas", st == 200 and deltas == want_d
              and sse.get("tokens") == sse.get("tokens_received")
              == DEC_SSE * DEC_NEW
              and sse.get("ttft_count") == sse.get("streams"),
              f"/metrics.prom ({len(text)} bytes) deltas {deltas} (want "
              f"{want_d}); phase 13's SSE streams: registry tokens "
              f"{sse.get('tokens')} and TTFT observations "
              f"{sse.get('ttft_count')} vs {sse.get('tokens_received')} "
              f"tokens received by {sse.get('streams')} streams")

        # (e) a predict-latency objective; a serve.apply delay fires it.
        # The windows first age out (d)'s dispatches.
        time.sleep(OPS_SLOW_S + 2 * OPS_TICK_S)
        st, _, _ = rid_request(port, "POST", "/observability/slo", {
            "name": "ops-predict", "kind": "latency", "target": 0.9,
            "thresholdMs": OPS_THRESHOLD_MS})
        rid_request(port, "POST", "/faults/serve.apply",
                    {"mode": "delay", "delayMs": OPS_DELAY_MS})
        t0, fired, sent = time.perf_counter(), None, 0
        while time.perf_counter() - t0 < 20 and fired is None:
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                list(pool.map(lambda i: rid_request(
                    port, "POST", "/serve/ops_fit/predict",
                    {"instances": x[i:i + 1].tolist()},
                    rid=f"ops-e-{sent + i}"), range(4)))
            sent += 4
            alerts = rid_request(port, "GET", "/observability/alerts")[1]
            fired = next((a for a in alerts["firing"]
                          if a["slo"] == "ops-predict"), None)
        fire_s = time.perf_counter() - t0
        rid_request(port, "DELETE", "/faults")
        t0, names_b = time.perf_counter(), []
        while time.perf_counter() - t0 < 15 and not names_b:
            names_b = [b["name"] for b in rid_request(
                port, "GET", "/observability/bundles")[1]["bundles"]]
            time.sleep(0.1)
        t0, resolved = time.perf_counter(), False
        while time.perf_counter() - t0 < 20 and not resolved:
            alerts = rid_request(port, "GET", "/observability/alerts")[1]
            resolved = any(e["state"] == "resolved"
                           and e["slo"] == "ops-predict"
                           for e in alerts["history"])
            time.sleep(OPS_TICK_S)
        resolve_s = time.perf_counter() - t0
        names_b = [b["name"] for b in rid_request(
            port, "GET", "/observability/bundles")[1]["bundles"]]
        manifest, flight_doc = {}, {}
        if names_b:
            manifest = rid_request(
                port, "GET", f"/observability/bundles/{names_b[0]}")[1]
            raw = server.bundles.read_file(names_b[0], "flight.json")
            flight_doc = json.loads(raw)
        events = flight_doc.get("snapshot", {}).get("events", {})
        delays = [e for e in events.get("faults", [])
                  if e.get("point") == "serve.apply"
                  and e.get("mode") == "delay"]
        e_rids = {e.get("requestId") for e in events.get("http", [])
                  if str(e.get("requestId", "")).startswith("ops-e-")}
        rid_request(port, "DELETE", "/observability/slo/ops-predict")
        line["slo"] = {"fired_after_s": fire_s, "predicts_sent": sent,
                       "burn_fast": (fired or {}).get("burnFast"),
                       "burn_slow": (fired or {}).get("burnSlow"),
                       "resolved_after_s": resolve_s, "bundles": names_b,
                       "bundle_files": [f["name"] for f in
                                        manifest.get("files", [])],
                       "delay_triggers_in_bundle": len(delays),
                       "request_ids_in_bundle": len(e_rids)}
        phase("ops SLO fires one bundle and resolves",
              st == 201 and fired is not None and len(names_b) == 1
              and manifest.get("reason") == "slo_firing"
              and manifest.get("detail", {}).get("slo") == "ops-predict"
              and delays and e_rids and resolved,
              f"objective ops-predict (p90 under {OPS_THRESHOLD_MS} ms, "
              f"windows {OPS_FAST_S}/{OPS_SLOW_S} s, tick {OPS_TICK_S} s) "
              f"under a {OPS_DELAY_MS} ms serve.apply delay: firing after "
              f"{fire_s:.2f}s ({sent} predicts; burn {line['slo']['burn_fast']}"
              f"/{line['slo']['burn_slow']}); bundles {names_b} (want one, "
              f"reason slo_firing: {manifest.get('reason')}); its "
              f"flight.json holds {len(delays)} delay triggers and "
              f"{len(e_rids)} of the predicts' request ids; resolved "
              f"{resolved} {resolve_s:.2f}s after the disarm")

        # (f) the plane's disabled costs and a predict p50 with it on.
        line["overhead"] = disabled_costs()
        lat = []
        for i in range(16):
            st, body, _ = rid_request(port, "POST", "/serve/ops_fit/predict",
                                      {"instances": x[i:i + 1].tolist()})
            if st == 200:
                lat.append(body["latencyMs"])
        line["overhead"]["predict_p50_ms"] = float(np.median(lat)) \
            if lat else None
        print(f"[info] operations plane overhead on {card}: "
              + json.dumps(line["overhead"]), flush=True)
    finally:
        faults.disarm_all()
        server.shutdown()
        rollup.reset_engine()
        slo.reset_service()
        bundle.reset_service()
    line["launches"] = launches
    line["seconds"] = time.perf_counter() - t_phase
    return {"launches": launches, "line": line}


# -- phase 21: the process entry point and the gateway -----------------------

ENTRY_MODEL = "bert-base"
ENTRY_CLIENTS = 16  # concurrent predicts of 1-8 rows at T = 128
ENTRY_CPU_ROWS = 4  # rows held against this process's CPU forward
ENTRY_P50_PREDICTS = 16  # one-row predicts, as phase 20's p50
ENTRY_BOOT_S = 240.0  # spawn to the first answer
ENTRY_EXIT_S = 60.0  # SIGINT to the exit
K5_SYMBOL = "dequantize_group_kernel"  # csrc/quant.cu
#: Substrings of library attention kernels' names (SDPA's flash,
#: memory-efficient and cuDNN routes): none may run on the served path.
LIBRARY_ATTENTION = ("fmha", "pytorch_flash", "flash_fwd_kernel",
                     "flash_fwd_splitkv", "efficient_attention",
                     "attention_kernel", "sdpa")


def keyed_request(port, verb, path, body, key):
    """(status, JSON body) of one request carrying ``X-Idempotency-Key``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(verb, "/api/learningOrchestra/v1" + path,
                     body=json.dumps(body),
                     headers={"Content-Type": "application/json",
                              "X-Idempotency-Key": key})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def run_entry_point(tmp, card: str, bert_artifact) -> dict:
    """Phase 21: the process a user starts, behind the gateway, with the
    lock witness on (see the module docstring, item 21).  The child's
    launch counters live in the child, so its K1 and K5 launches are read
    from its own capture's device records."""
    import socket

    from learningorchestra_tpu_torch.analysis.wholeprogram import (
        global_graph,
    )
    from learningorchestra_tpu_torch.analysis.witness import (
        cross_check,
        load_dump,
    )
    from learningorchestra_tpu_torch.client import ClientError, Context
    from learningorchestra_tpu_torch.serve.service import ARTIFACT_TYPE
    from learningorchestra_tpu_torch.store.volumes import VolumeStorage
    from learningorchestra_tpu_torch.train.neural import load_artifact

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    VolumeStorage(f"{tmp}/volumes").save_object(ARTIFACT_TYPE, ENTRY_MODEL,
                                                bert_artifact)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dump, log_path = f"{tmp}/witness.json", f"{tmp}/serve.log"
    env = {**os.environ, "PYTHONPATH": repo,
           "LO_TPU_STORE_ROOT": f"{tmp}/store",
           "LO_TPU_VOLUME_ROOT": f"{tmp}/volumes",
           "LO_TPU_WITNESS": "1", "LO_TPU_WITNESS_DUMP": dump}
    rng = np.random.default_rng(21)
    reqs = [rng.integers(1, 30522, (1 + i % 8, TRAIN_SHAPE[2])).astype(
        np.int32) for i in range(ENTRY_CLIENTS)]
    for x in reqs[::3]:
        x[0, int(rng.integers(16, TRAIN_SHAPE[2])):] = 0  # pad tails
    ok, line, launches = True, {"card": card}, {}

    def check(name, good, detail):
        nonlocal ok
        phase(f"entry point {name}", good, detail)
        ok &= bool(good)

    t0 = time.perf_counter()
    log = open(log_path, "w")
    child = subprocess.Popen(
        [sys.executable, "-m", "learningorchestra_tpu_torch", "serve",
         "--port", str(port)], cwd=repo, env=env, stdout=log,
        stderr=subprocess.STDOUT)
    try:
        ctx = Context(f"http://127.0.0.1:{port}", request_timeout=600)
        while True:
            if child.poll() is not None:
                raise RuntimeError(f"serve exited {child.returncode} at "
                                   "boot")
            try:
                ctx.request("GET", "/health")
                break
            except (OSError, ClientError):
                if time.perf_counter() - t0 > ENTRY_BOOT_S:
                    raise RuntimeError("serve never answered") from None
                time.sleep(0.1)
        line["boot_to_first_answer_s"] = time.perf_counter() - t0

        # (b) the load and the concurrent predicts under one capture.
        t0 = time.perf_counter()
        ctx.observability.profile_start(name="entry", max_seconds=120)
        line["profile_start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = ctx.serve.load(ENTRY_MODEL)
        line["load_s"] = time.perf_counter() - t0

        def one(x):
            t1 = time.perf_counter()
            try:
                return 200, ctx.serve.predict(ENTRY_MODEL, x.tolist()), \
                    time.perf_counter() - t1
            except ClientError as exc:
                return exc.status, exc.payload, time.perf_counter() - t1

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(ENTRY_CLIENTS) as pool:
            answers = list(pool.map(one, reqs))
        line["burst_wall_s"] = time.perf_counter() - t0
        stopped = ctx.observability.profile_stop()
        files = [f["path"] for f in stopped.get("capture", {}).get(
            "files", []) if f["path"].endswith(".pt.trace.json")]
        events = json.loads(ctx.observability.profile_fetch(
            "entry", files[0])).get("traceEvents", []) if files else []
        kernels = [str(e.get("name", "")) for e in events
                   if e.get("cat") == "kernel"]
        k1 = sum(K1_SYMBOL in k for k in kernels)
        k5 = sum(K5_SYMBOL in k for k in kernels)
        library = sorted({k for k in kernels if K1_SYMBOL not in k and any(
            s in k.lower() for s in LIBRARY_ATTENTION)})
        unrecorded, runtime = unrecorded_launches(events)
        stats = ctx.serve.list_loaded()["stats"]["models"][ENTRY_MODEL]
        dispatches = stats["batches"]
        launches["load"] = {"dequantize_rowwise": k5}
        launches["predict"] = {"flash_fwd": k1}
        good = all(st == 200 and np.asarray(b.get("predictions")).shape
                   == (len(x), 2) and np.isfinite(
                       np.asarray(b["predictions"])).all()
                   for x, (st, b, _) in zip(reqs, answers))
        check("load and predicts", bool(loaded.get("result")) and good,
              f"POST /serve/{ENTRY_MODEL}/load in {line['load_s']:.2f}s; "
              f"{len(reqs)} concurrent predicts of 1-8 rows at "
              f"T={TRAIN_SHAPE[2]}: statuses "
              f"{sorted({st for st, _, _ in answers})}, {dispatches} "
              f"dispatches, buckets {stats.get('bucketHistogram')}")
        check("capture launches", files and k5 == 1
              and k1 == 12 * dispatches and not library and not unrecorded,
              f"child's capture: {len(kernels)} kernels, {K5_SYMBOL} {k5} "
              f"(want 1: one grouped load), {K1_SYMBOL} {k1} (want 12 x "
              f"{dispatches} dispatches), library attention {library}, "
              f"launches without a device record {len(unrecorded)} of "
              f"{len(runtime)}")
        picks = [(i, r) for i, x in enumerate(reqs) for r in range(len(x))
                 ][::7][:ENTRY_CPU_ROWS]
        t0 = time.perf_counter()
        ref = load_artifact(bert_artifact, device="cpu").predict(
            np.stack([reqs[i][r] for i, r in picks]))
        cpu_s = time.perf_counter() - t0
        got = np.stack([np.asarray(answers[i][1]["predictions"])[r]
                        for i, r in picks]) if good else np.inf
        err = float(np.abs(got - ref).max())
        check("rows vs CPU", err <= CPU_ATOL,
              f"rows {picks}: max|dlogit| {err:.3g} atol {CPU_ATOL} (CPU "
              f"{cpu_s:.1f}s)")
        lat = [ctx.serve.predict(ENTRY_MODEL, reqs[0][:1].tolist())[
            "latencyMs"] for _ in range(ENTRY_P50_PREDICTS)]
        line.update(
            dispatches=dispatches, cpu_max_abs_err=err,
            burst_client_ms_p50=float(np.median(
                [s for _, _, s in answers])) * 1e3,
            predict_p50_ms_witness_on=float(np.median(lat)),
            capture={"kernels": len(kernels), "k1": k1, "k5": k5,
                     "library_attention": library})

        # (c) the gateway.
        marker = f"{tmp}/idem_runs.txt"
        body = {"name": "entry_fn",
                "function": f"open({marker!r}, 'a').write('x')\n"
                            "response = 1"}
        key = "entry-" + os.urandom(8).hex()
        first = keyed_request(port, "POST", "/function/python", body, key)
        ctx.observe.wait("entry_fn", timeout=60)
        again = keyed_request(port, "POST", "/function/python", body, key)
        other = keyed_request(port, "POST", "/function/python",
                              dict(body, name="entry_fn2"), key)
        runs = open(marker).read() if os.path.exists(marker) else ""
        check("idempotent replay", first[0] == again[0] == 201
              and again[1] == first[1] and runs == "x" and other[0] == 422,
              f"keyed POST /function/python -> {first[0]}, replayed -> "
              f"{again[0]} (equal body {again[1] == first[1]}), the job ran "
              f"{len(runs)} time(s); the key on another body -> {other[0]}")
        listing = [ctx.request("GET", "/registry") for _ in range(4)]
        ctx.request("DELETE", "/function/python/entry_fn")
        listing.append(ctx.request("GET", "/registry"))
        http_ring = [e for e in ctx.observability.flight(
            ["http"])["events"]["http"] if e.get("route") == "GET /registry"]
        ms = [e["ms"] for e in http_ring[-5:]]
        check("cached GET", len(ms) == 5 and all(
            doc == listing[0] for doc in listing) and max(ms[1:4]) < min(
                ms[0], ms[4]),
              f"GET /registry x4, a DELETE, GET /registry: gateway ms "
              f"{[round(m, 3) for m in ms]} (hits under both misses: the "
              f"first fills the cache, the DELETE clears it)")
        metrics = ctx.metrics()
        route = metrics["routes"].get(
            "POST /serve/(?P<name>[A-Za-z0-9_.\\-]+)/predict", {})
        want = len(reqs) + ENTRY_P50_PREDICTS
        check("metrics", route.get("count") == want
              and metrics["budget"]["request_timeout_s"] > 0,
              f"GET /metrics: predict route {route} (want count {want}); "
              f"budget {metrics['budget']}")
        status_page = ctx.request("GET", "/status", raw=True).decode()
        check("status page", "<h1>learningorchestra_tpu_torch</h1>"
              in status_page and "Device leases" in status_page,
              f"GET /status: {len(status_page)} bytes of HTML")
        locks = ctx.observability.locks()
        check("locks", locks["enabled"] is True and locks["edges"]
              and not locks["stalls"],
              f"GET /observability/locks: {len(locks['edges'])} edges, "
              f"{len(locks['events'])} contention events, "
              f"{locks['registeredLocks']} witnessed locks, stalls "
              f"{locks['stalls']}")

        # (d) the exit.
        t0 = time.perf_counter()
        child.send_signal(signal.SIGINT)
        rc = child.wait(ENTRY_EXIT_S)
        line["exit_s"] = time.perf_counter() - t0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(30)
        log.close()
    snap = load_dump(dump) if os.path.exists(dump) else {}
    unmatched = cross_check(snap, global_graph(
        os.path.join(repo, "learningorchestra_tpu_torch")))
    check("exit and witness dump", rc == 0 and snap.get("enabled")
          and snap.get("edges") and not unmatched,
          f"SIGINT -> exit {rc} in {line['exit_s']:.2f}s (bound "
          f"{ENTRY_EXIT_S}s); dump: {len(snap.get('edges', []))} edges, "
          f"{len(snap.get('events', []))} events, unmatched "
          f"{[f.message for f in unmatched]}")
    line.update(witness_edges=len(snap.get("edges", [])),
                witness_events=len(snap.get("events", [])),
                unmatched_edges=len(unmatched), launches=launches,
                seconds=time.perf_counter() - t_phase)
    if not ok:
        with open(log_path) as fh:
            print("  entry point child log (tail):\n" + fh.read()[-4000:],
                  flush=True)
    return {"ok": ok, "launches": launches, "line": line}


# -- phase 22: the control plane, store HA and the native store ---------------

CP_TTL_S = 3.0  # a claim or engine older than this is stolen
CP_HEARTBEAT_S = 0.5
CP_SWEEP_S = 0.5
CP_HOLD_MS = 600_000  # engine A's second epoch holds at its top until killed
CP_STANDBY_INTERVAL_S = 0.25
CP_STANDBY_MISSES = 4
CP_RETRY_AFTER_S = 2.0
CP_BOOT_S = 240.0  # spawn to the first answer
CP_JOB_S = 600.0  # the stolen fit's deadline
CP_STORM_ACKED = 12  # acknowledged writes before B is killed
CP_PREDICT_ROWS = (1, 2, 3, 4, 5, 6, 7, 8)  # one request each, T = 128
CP_REVIVE_S = 120.0
SERVE_REFUSED_STATUS = 3  # api/server.py SERVE_REFUSED
K2_SYMBOL, K3_SYMBOL = "flash_bwd_dq_", "flash_bwd_dkv_"  # csrc/flash_bwd.cu
K4_SYMBOL = "quantize_group_kernel"  # csrc/quant.cu (not the dequantize)


def tenant_request(port, verb, path, body, tenant=None):
    """(status, headers, JSON body) of one request carrying ``X-Tenant``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Content-Type": "application/json"}
    if tenant:
        headers["X-Tenant"] = tenant
    try:
        conn.request(verb, "/api/learningOrchestra/v1" + path,
                     body=None if body is None else json.dumps(body),
                     headers=headers)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def capture_kernels(ctx, name: str) -> dict:
    """Stop a child's capture and count the port's kernels among its
    device records (the child's own counters stay in the child)."""
    stopped = ctx.observability.profile_stop()
    files = [f["path"] for f in stopped.get("capture", {}).get("files", [])
             if f["path"].endswith(".pt.trace.json")]
    events = json.loads(ctx.observability.profile_fetch(
        name, files[0])).get("traceEvents", []) if files else []
    kernels = [str(e.get("name", "")) for e in events
               if e.get("cat") == "kernel"]
    unrecorded, runtime = unrecorded_launches(events)
    return {
        "files": len(files), "kernels": len(kernels),
        "flash_fwd": sum(K1_SYMBOL in k for k in kernels),
        "flash_bwd_dq": sum(K2_SYMBOL in k for k in kernels),
        "flash_bwd_dkv": sum(K3_SYMBOL in k for k in kernels),
        "quantize_rowwise": sum(K4_SYMBOL in k and K5_SYMBOL not in k
                                for k in kernels),
        "dequantize_rowwise": sum(K5_SYMBOL in k for k in kernels),
        "library_attention": sorted({
            k for k in kernels if K1_SYMBOL not in k and any(
                s in k.lower() for s in LIBRARY_ATTENTION)}),
        "unrecorded": len(unrecorded), "runtime": len(runtime)}


def journal_events(store: str, job: str) -> list:
    """The job's journal records, read from the shared store's WAL."""
    out = {}
    path = os.path.join(store, "_job_journal.wal")
    with open(path, "rb") as fh:
        for raw in fh:
            try:
                op = json.loads(raw)
            except ValueError:
                continue  # a torn tail
            if op.get("op") == "i" and op["d"].get("job") == job:
                out[op["d"]["_id"]] = op["d"]
            elif op.get("op") == "d":
                out.pop(op.get("id"), None)
    return [out[k] for k in sorted(out)]


def native_vs_python_ingest(tmp) -> dict:
    """Phase 11's Covertype-schema CSV (100,000 rows, sharded) through the
    native store and CSV engine, and through the python store and its row
    path: the same shards byte for byte."""
    from learningorchestra_tpu_torch.config import Config
    from learningorchestra_tpu_torch.services import dataset
    from learningorchestra_tpu_torch.services.context import ServiceContext
    from learningorchestra_tpu_torch.store.sharded import ShardedDataset

    os.makedirs(tmp, exist_ok=True)
    cov = covtype_inputs()
    header = [f"Elevation_{i}" for i in range(10)] + [
        f"Wilderness_Area{i}" for i in range(4)] + [
        f"Soil_Type{i}" for i in range(40)] + ["Cover_Type"]
    csv = f"{tmp}/covtype.csv"
    np.savetxt(csv, np.concatenate([
        cov["x"][:COVTYPE_STREAM_ROWS],
        cov["y"][:COVTYPE_STREAM_ROWS, None]], axis=1),
        fmt=["%.4f"] * 10 + ["%d"] * 45, delimiter=",",
        header=",".join(header), comments="")
    del cov
    out = {"bytes": os.path.getsize(csv)}
    shards = {}
    real_native = dataset._native
    for engine, backend in (("native", "native"), ("python", "python")):
        cfg = Config()
        cfg.store.root = f"{tmp}/{engine}/store"
        cfg.store.volume_root = f"{tmp}/{engine}/volumes"
        cfg.store.backend = backend
        if engine == "python":
            dataset._native = lambda: None  # the Python row path
        ctx = ServiceContext(cfg, device="cpu")
        try:
            t0 = time.perf_counter()
            dataset.DatasetService(ctx).create_csv(
                "covtype", f"file://{csv}", shard_rows=COVTYPE_STREAM_SHARD)
            ctx.engine.wait("covtype", timeout=600)
            secs = time.perf_counter() - t0
            meta = ctx.artifacts.metadata.read("covtype")
            ds = ShardedDataset(ctx.volumes.path_for("dataset/csv",
                                                     "covtype"))
            shards[engine] = [{k: (v.dtype.str, v.tobytes()) for k, v in
                               ds.load_shard(i).items()}
                              for i in range(ds.n_shards)]
            preview = ctx.documents.find("covtype", query={
                "_id": {"$gte": 1}, "docType": {"$ne": "execution"}})
            out[engine] = {"seconds": secs, "rows": meta.get("rows"),
                           "shards": meta.get("shards"),
                           "engine": meta.get("engine"),
                           "store": type(ctx.documents).__name__,
                           "rows_per_s": (meta.get("rows") or 0) / secs,
                           "preview": len(preview)}
            out[engine + "_preview"] = preview
        finally:
            dataset._native = real_native
            ctx.close()
    previews = out.pop("native_preview"), out.pop("python_preview")
    out["equal"] = (shards["native"] == shards["python"]
                    and previews[0] == previews[1])
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True)
    out["gxx"] = gxx.stdout.splitlines()[0] if gxx.returncode == 0 else \
        gxx.stderr.strip()
    return out


def run_control_plane(tmp, card: str, ops_line: dict) -> dict:
    """Phase 22: two ``serve`` engines sharing one store through the claim
    table, a warm ``standby`` over that store, all three on the card; the
    native store against the python one (see the module docstring, item
    22).  The children's launch counters stay in the children, so their
    K1-K5 launches are read from their own captures."""
    import socket

    from learningorchestra_tpu_torch.client import ClientError, Context

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    store, vol, replica = f"{tmp}/store", f"{tmp}/volumes", f"{tmp}/replica"
    ports = []
    for _ in range(3):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    pa, pb, ps = ports
    x, y = make_train_data(30522)
    x, y = x[:OPS_ROWS], y[:OPS_ROWS]
    csv = f"{tmp}/cp_tokens.csv"
    os.makedirs(tmp, exist_ok=True)
    with open(csv, "w") as fh:
        fh.write(",".join(REST_FIELDS + ["label"]) + "\n")
        for row, label in zip(x, y):
            fh.write(",".join(map(str, row)) + f",{label}\n")
    base_env = {**os.environ, "PYTHONPATH": repo,
                "LO_TPU_VOLUME_ROOT": vol, "LO_TPU_PROF_MAX_S": "900"}
    base_env.pop("LO_TPU_WITNESS", None)
    engine_env = {**base_env, "LO_TPU_STORE_ROOT": store,
                  "LO_TPU_STORE_BACKEND": "python",
                  "LO_TPU_CLUSTER_ENABLED": "1",
                  "LO_TPU_CLUSTER_HEARTBEAT_S": str(CP_HEARTBEAT_S),
                  "LO_TPU_CLUSTER_TTL_S": str(CP_TTL_S),
                  "LO_TPU_CLUSTER_SWEEP_S": str(CP_SWEEP_S),
                  "LO_TPU_TENANT_MAX_RUNNING": "1",
                  "LO_TPU_TENANT_RETRY_AFTER_S": str(CP_RETRY_AFTER_S)}
    envs = {
        "A": {**engine_env, "LO_TPU_CLUSTER_ENGINE_ID": "A",
              # Epoch 0 runs free and checkpoints; epoch 1 holds at its
              # top until the kill.
              "LO_TPU_FAULT_TRAIN_EPOCH": f"delay:ms={CP_HOLD_MS},after=1"},
        "B": {**engine_env, "LO_TPU_CLUSTER_ENGINE_ID": "B"},
    }
    logs = {k: f"{tmp}/{k}.log" for k in ("A", "B", "standby", "revived")}
    procs: dict = {}
    ok, line = True, {"card": card}
    launches: dict = {}

    def check(name, good, detail):
        nonlocal ok
        phase(f"control plane {name}", good, detail)
        ok &= bool(good)

    def spawn(key, argv, env):
        with open(logs[key], "w") as fh:
            procs[key] = subprocess.Popen(
                [sys.executable, "-m", "learningorchestra_tpu_torch", *argv],
                cwd=repo, env=env, stdout=fh, stderr=subprocess.STDOUT)

    def wait_until(cond, timeout_s, what, *keys):
        t0 = time.perf_counter()
        while True:
            for key in keys:
                if procs[key].poll() is not None:
                    raise RuntimeError(f"{key} exited "
                                       f"{procs[key].returncode} waiting for "
                                       f"{what}")
            got = cond()
            if got:
                return got
            if time.perf_counter() - t0 > timeout_s:
                raise RuntimeError(f"timed out waiting for {what}")
            time.sleep(0.05)

    def answers(port):
        try:
            return tenant_request(port, "GET", "/health", None)[0] == 200
        except OSError:
            return False

    # (g) runs on a thread of its own from the start: this process only
    # polls the children meanwhile.
    ingest: dict = {}
    ingest_thread = threading.Thread(
        target=lambda: ingest.update(native_vs_python_ingest(
            f"{tmp}/ingest")), name="cp-ingest", daemon=True)
    ingest_thread.start()
    t0 = time.perf_counter()
    spawn("A", ["serve", "--port", str(pa)], envs["A"])
    spawn("B", ["serve", "--port", str(pb)], envs["B"])
    spawn("standby", ["standby", "--primary", f"127.0.0.1:{pb}",
                      "--primary-store", store, "--replica", replica,
                      "--port", str(ps), "--host", "127.0.0.1",
                      "--interval", str(CP_STANDBY_INTERVAL_S),
                      "--misses", str(CP_STANDBY_MISSES)], base_env)
    ctx_a = Context(f"http://127.0.0.1:{pa}", request_timeout=600)
    ctx_b = Context(f"http://127.0.0.1:{pb}", request_timeout=600)
    ctx_s = Context(f"http://127.0.0.1:{ps}", request_timeout=600)
    job = "cp_fit"
    try:
        wait_until(lambda: answers(pa) and answers(pb), CP_BOOT_S,
                   "both engines", "A", "B")
        line["engines_boot_s"] = time.perf_counter() - t0

        def standby_armed():
            try:
                return ctx_s.request("GET", "/replication/status").get(
                    "saw_primary")
            except (OSError, ClientError):
                return False

        wait_until(standby_armed, CP_BOOT_S, "the standby", "standby")
        line["standby_armed_s"] = time.perf_counter() - t0
        # B's capture starts while A works: a first start in a fresh
        # process takes ~10 s (CUPTI and the warm-up).
        def start_capture(ctx, name, key):
            t1 = time.perf_counter()
            ctx.observability.profile_start(name=name, max_seconds=900)
            line[key] = time.perf_counter() - t1

        b_capture = threading.Thread(target=start_capture, args=(
            ctx_b, "cp_b", "b_capture_start_s"), daemon=True)
        b_capture.start()

        # (a) engine A: ingest, projection, model, the fit under tenant t22.
        for key, path, body, name in (
                ("ingest", "/dataset/csv",
                 {"datasetName": "cp", "url": f"file://{csv}"}, "cp"),
                ("projection", "/transform/projection",
                 {"projectionName": "cp_x", "datasetName": "cp",
                  "fields": REST_FIELDS}, "cp_x"),
                ("model", "/model/tensorflow",
                 {"modelName": "cp_bert", "class": "BertModel",
                  "modulePath": "learningorchestra_tpu.models.text",
                  "classParameters": REST_MODEL}, "cp_bert")):
            t1 = time.perf_counter()
            st, created = request(pa, "POST", path, body)
            meta = wait_done(pa, name) if st == 201 else created
            secs = time.perf_counter() - t1
            check(f"engine A {key}", st == 201
                  and meta.get("jobState") == "finished",
                  f"POST {path} -> {st}, {meta.get('jobState')} in "
                  f"{secs:.2f}s")
        fit = {"x": "$cp_x", "y": "$cp.label", "epochs": OPS_EPOCHS,
               "batch_size": TRAIN_SHAPE[0], "shuffle": False,
               "checkpoint_every": 1, "checkpoint_min_interval_s": 0,
               "checkpoint_async": False, "quantize_checkpoint": True}
        st, _, _ = tenant_request(pa, "POST", "/train/tensorflow", {
            "name": job, "parentName": "cp_bert", "method": "fit",
            "methodParameters": fit}, tenant="t22")
        steps_epoch = OPS_ROWS // TRAIN_SHAPE[0]
        marker = f"{vol}/_checkpoints/{job}/latest.json"

        def first_checkpoint():
            try:
                with open(marker) as fh:
                    return json.load(fh).get("step", 0) >= 1  # epoch 0
            except (OSError, ValueError):
                return False

        t1 = time.perf_counter()
        wait_until(first_checkpoint, CP_JOB_S, "A's first checkpoint", "A")
        line["a_first_checkpoint_s"] = time.perf_counter() - t1

        # (b) tenant quotas answer alike on both engines.
        fn = {"function": "response = 1"}
        rej = {}
        for key, port in (("A", pa), ("B", pb)):
            rej[key] = tenant_request(port, "POST", "/function/python",
                                      {"name": f"cp_fn_{key}", **fn},
                                      tenant="t22")
        other = tenant_request(pb, "POST", "/function/python",
                               {"name": "cp_fn_other", **fn},
                               tenant="t-other")
        missing = tenant_request(pb, "GET", "/function/python/cp_fn_A",
                                 None)[0]
        status_b = ctx_b.cluster.status()
        check("tenant 429s", st == 201 and all(
            r[0] == 429 and r[1].get("Retry-After") == str(CP_RETRY_AFTER_S)
            for r in rej.values())
            and rej["A"][2]["error"] == rej["B"][2]["error"]
            and other[0] == 201 and missing == 404
            and status_b.get("tenants", {}).get("t22", {}).get("running")
            == 1,
            f"fit under X-Tenant t22 -> {st}; a job of t22 on A -> "
            f"{rej['A'][0]} ({rej['A'][1].get('Retry-After')}), on B -> "
            f"{rej['B'][0]} ({rej['B'][1].get('Retry-After')}), the same "
            f"error {rej['A'][2].get('error')!r}; t-other on B -> "
            f"{other[0]}; the refused job left {missing}; tenants "
            f"{status_b.get('tenants')}")
        claims = {c["job"]: c for c in status_b.get("claims", [])}
        check("claim table before the kill", claims.get(job, {}).get(
            "engine") == "A" and claims[job].get("state") == "live"
            and sorted(e["engine"] for e in status_b.get("engines", [])
                       if e.get("live")) == ["A", "B"],
            f"B's /cluster/status: engines {status_b.get('engines')}, "
            f"claim {claims.get(job)}")
        epochs = {e["engine"]: e["epoch"] for e in status_b["engines"]}
        line["engine_epochs"] = epochs

        # (c) kill A mid-fit; B steals the claim and resumes.
        b_capture.join(120)
        if "b_capture_start_s" not in line:
            raise RuntimeError("B's capture did not start")
        procs["A"].send_signal(signal.SIGKILL)
        procs["A"].wait(30)
        t_kill = time.perf_counter()

        def stolen():
            st_ = ctx_b.cluster.status()
            c = {c["job"]: c for c in st_.get("claims", [])}.get(job, {})
            return c.get("engine") == "B"

        wait_until(stolen, CP_JOB_S, "the steal", "B")
        line["steal_s"] = time.perf_counter() - t_kill

        def finished():
            _, _, meta = tenant_request(pb, "GET",
                                        f"/train/tensorflow/{job}", None)
            meta = meta[0] if meta else {}
            return meta if meta.get("jobState") in ("finished",
                                                    "failed") else None

        meta = wait_until(finished, CP_JOB_S, "the resumed fit", "B")
        line["resume_to_finished_s"] = time.perf_counter() - t_kill
        cap_b = capture_kernels(ctx_b, "cp_b")
        trace = ctx_b.request("GET", f"/observability/jobs/{job}/trace")
        run_epochs = sorted(s["attrs"]["epoch"] for s in trace.get(
            "spans", []) if s.get("name") == "epoch")
        steps_b = steps_epoch * len(run_epochs)
        events = journal_events(store, job)
        finished_ev = [e for e in events if e.get("event") == "finished"]
        launches["b"] = {k: cap_b[k] for k in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
            "quantize_rowwise", "dequantize_rowwise")}
        want_b = {"flash_fwd": REST_LAYERS * steps_b,
                  "flash_bwd_dq": REST_LAYERS * steps_b,
                  "flash_bwd_dkv": REST_LAYERS * steps_b,
                  "quantize_rowwise": 1, "dequantize_rowwise": 0}
        check("steal and resume", meta.get("jobState") == "finished"
              and run_epochs == list(range(1, OPS_EPOCHS))
              and launches["b"] == want_b and not cap_b["library_attention"]
              and not cap_b["unrecorded"],
              f"claim stolen {line['steal_s']:.2f}s after the kill (TTL "
              f"{CP_TTL_S}s), finished {line['resume_to_finished_s']:.2f}s "
              f"after it; epochs run on B {run_epochs} ({steps_b} steps); "
              f"B's capture {launches['b']} (want {want_b}), library "
              f"attention {cap_b['library_attention']}, launches without "
              f"a device record {cap_b['unrecorded']} of {cap_b['runtime']}")
        check("one publication under B's epoch", len(finished_ev) == 1
              and finished_ev[0].get("epoch") == epochs.get("B")
              == meta.get("engineEpoch") != epochs.get("A"),
              f"journal events of {job}: "
              f"{[(e.get('event'), e.get('epoch')) for e in events]}; "
              f"engineEpoch {meta.get('engineEpoch')}, epochs {epochs}")
        rows = ctx_b.request("GET", f"/train/tensorflow/{job}")
        losses = [r["loss"] for r in sorted(
            (r for r in rows if r.get("docType") == "history"),
            key=lambda r: r["epoch"])]
        twin = (ops_line.get("preempt") or {}).get("twin_losses") or []
        rel = max((abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(losses, twin)), default=float("inf"))
        check("losses equal phase 20's twin", len(losses) == len(twin)
              == OPS_EPOCHS and rel <= OPS_LOSS_RTOL,
              f"losses {losses} vs phase 20's unfaulted twin {twin}: max "
              f"relative {rel:.3g} (bar {OPS_LOSS_RTOL})")
        line.update(losses=losses, twin_losses=twin, loss_rel_err=rel,
                    epochs_on_b=run_epochs, b_capture=cap_b)

        # (d) predict with B, then a write storm; kill B mid-storm.
        rng = np.random.default_rng(22)
        reqs = [rng.integers(1, 30522, (n, TRAIN_SHAPE[2])).astype(np.int32)
                for n in CP_PREDICT_ROWS]
        ctx_b.serve.load(job)
        b_rows = [np.asarray(ctx_b.serve.predict(job, r.tolist())[
            "predictions"], np.float32) for r in reqs]
        storm_ctx = Context(f"http://127.0.0.1:{pb}", request_timeout=600,
                            failover=f"127.0.0.1:{ps}")
        acked, stop = [], threading.Event()

        def storm():
            # A write that got an error was not acknowledged: the next
            # one takes a fresh name.
            i = 0
            while not stop.is_set():
                name = f"cp_w{i}"
                i += 1
                try:
                    storm_ctx.request("POST", "/function/python",
                                      {"name": name, **fn})
                    acked.append((name, time.perf_counter()))
                except (OSError, ClientError):
                    time.sleep(0.02)

        writer = threading.Thread(target=storm, daemon=True)
        writer.start()
        wait_until(lambda: len(acked) >= CP_STORM_ACKED, 120,
                   "the storm", "B", "standby")
        procs["B"].send_signal(signal.SIGKILL)
        procs["B"].wait(30)
        t_kill = time.perf_counter()
        before = len(acked)
        wait_until(lambda: any(t > t_kill for _, t in acked), 120,
                   "a write on the promoted standby", "standby")
        line["takeover_s"] = min(t for _, t in acked if t > t_kill) - t_kill
        stop.set()
        writer.join(60)
        lost = []
        for name, _ in acked:
            try:
                got = ctx_s.request("GET", f"/function/python/{name}")
                if not got or got[0].get("name") != name:
                    lost.append(name)
            except ClientError:
                lost.append(name)
        promoted = json.load(open(f"{replica}/.promoted"))
        fence = json.load(open(f"{store}/.fenced"))
        check("standby promotes, no acknowledged write lost",
              not lost and str(ps) in storm_ctx.base
              and promoted.get("epoch") == fence.get("epoch") == 1,
              f"B killed after {before} acknowledged writes; the first write "
              f"on the standby {line['takeover_s']:.2f}s after the kill "
              f"(probe {CP_STANDBY_INTERVAL_S}s x {CP_STANDBY_MISSES}); "
              f"{len(acked)} acknowledged, lost {lost}; the client now at "
              f"{storm_ctx.base}; promotion epoch {promoted.get('epoch')}, "
              f"fence {fence.get('promoted_to')}")

        # (f) B restarted with the standby as its HA peer must refuse; it
        # boots while (e) runs.
        t_revive = time.perf_counter()
        spawn("revived", ["serve", "--port", str(pb)],
              {**envs["B"], "LO_HA_PEER": f"127.0.0.1:{ps}"})

        # (e) the promoted standby serves on the card: K5 once, K1 per
        # dispatch, rows as B's.
        start_capture(ctx_s, "cp_s", "standby_capture_start_s")
        st0 = ctx_s.serve.list_loaded()["stats"]["models"].get(
            job, {"batches": 0})["batches"]
        ctx_s.serve.load(job)
        s_rows = [np.asarray(ctx_s.serve.predict(job, r.tolist())[
            "predictions"], np.float32) for r in reqs]
        dispatches = ctx_s.serve.list_loaded()["stats"]["models"][job][
            "batches"] - st0
        cap_s = capture_kernels(ctx_s, "cp_s")
        launches["standby_load"] = {"dequantize_rowwise":
                                    cap_s["dequantize_rowwise"]}
        launches["standby_predict"] = {"flash_fwd": cap_s["flash_fwd"]}
        err = max(float(np.abs(a - b).max()) for a, b in zip(s_rows, b_rows))
        check("promoted standby serves on the card",
              cap_s["dequantize_rowwise"] == 1
              and cap_s["flash_fwd"] == REST_LAYERS * dispatches
              and dispatches == len(reqs) and err <= CPU_ATOL
              and not cap_s["library_attention"] and not cap_s["unrecorded"],
              f"standby capture: {K5_SYMBOL} {cap_s['dequantize_rowwise']} "
              f"(want 1), {K1_SYMBOL} {cap_s['flash_fwd']} (want "
              f"{REST_LAYERS} x {dispatches} dispatches); rows vs B's before "
              f"the kill max|dlogit| {err:.3g} (atol {CPU_ATOL}); library "
              f"attention {cap_s['library_attention']}")
        line.update(standby_capture=cap_s, standby_vs_b_max_abs=err,
                    standby_dispatches=dispatches,
                    acknowledged_writes=len(acked), lost_writes=len(lost))

        rc = procs["revived"].wait(CP_REVIVE_S)
        line["revived_exit_s"] = time.perf_counter() - t_revive
        said = open(logs["revived"]).read()
        check("revived primary refuses", rc == SERVE_REFUSED_STATUS
              and "fenced" in said and not answers(pb),
              f"serve with LO_HA_PEER=127.0.0.1:{ps} -> exit {rc} (want "
              f"{SERVE_REFUSED_STATUS}) in {line['revived_exit_s']:.2f}s")
        procs["standby"].send_signal(signal.SIGINT)
        line["standby_exit"] = procs["standby"].wait(60)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    if not ok:
        for key, path in logs.items():
            if os.path.exists(path):
                with open(path) as fh:
                    print(f"  control plane {key} log (tail):\n"
                          + fh.read()[-3000:], flush=True)

    # (g) the native store and CSV engine against the python ones.
    ingest_thread.join(600)
    if "equal" not in ingest:
        raise RuntimeError("the native-vs-python ingest did not finish")
    n, p = ingest["native"], ingest["python"]
    check("native vs python ingest", ingest["equal"]
          and n["rows"] == p["rows"] == COVTYPE_STREAM_ROWS
          and n["engine"] == "native" and p["engine"] is None
          and n["store"] == "NativeDocumentStore"
          and p["store"] == "DocumentStore",
          f"{COVTYPE_STREAM_ROWS} rows x 55 columns ({ingest['bytes']} B) "
          f"in {n['shards']} shards: native {n['seconds']:.2f}s "
          f"({n['rows_per_s']:.0f} rows/s), python {p['seconds']:.2f}s "
          f"({p['rows_per_s']:.0f} rows/s); shards and preview equal "
          f"{ingest['equal']}; {ingest['gxx']}")
    line.update(native_store=ingest, seconds=time.perf_counter() - t_phase)
    return {"ok": ok, "launches": launches, "line": line}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a GPU", file=sys.stderr)
        return 2
    try:
        from learningorchestra_tpu_torch import convert
        from learningorchestra_tpu_torch.kernels import build
        from learningorchestra_tpu_torch.models.text import BertModel
        from learningorchestra_tpu_torch.ops import attention, quant
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing beside this "
              f"script ({exc})", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The cost plane reports MFU against the card's dense bf16 peak (read
    # at its first use, so before any phase runs).
    os.environ["LO_TPU_COSTS_PEAK_FLOPS"] = repr(COSTS_PEAK_FLOPS)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    phase("device", smi.returncode == 0,
          f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(card, flush=True)

    t0 = time.perf_counter()
    try:
        secs = build.build()
        phase("build", True, f"{ {k: round(v, 2) for k, v in secs.items()} } "
              f"wall {time.perf_counter() - t0:.2f}s (nvcc -gencode "
              "arch=compute_90a,code=sm_90a, one process per source)")
    except build.KernelBuildError as exc:
        phase("build", False, str(exc))
        return 1
    tc, spilled = [], []
    for name, log in build.build_log.items():
        report = ptxas_report(log)
        print(f"  ptxas {name}: " + "; ".join(
            f"{k} {regs} registers, spill stores {st} B, loads {ld} B"
            for k, regs, st, ld in report), flush=True)
        tc += [k for k, *_ in report if "_tc_" in k]
        spilled += [k for k, _, st, ld in report if st or ld]
    families = {k.split("_tc_")[0] for k in tc}
    phase("tensor-core registers",
          {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"} <= families
          and not any("_tc_" in k for k in spilled),
          f"tensor-core instances {tc}; kernels that spill: {spilled}")
    quant_kernels = [k for k, *_ in ptxas_report(build.build_log["quant"])]
    phase("quant registers",
          {"quantize_group_kernel", "dequantize_group_kernel"}
          <= set(quant_kernels)
          and not any(k in spilled for k in quant_kernels),
          f"quant.cu kernels {quant_kernels}; none may spill")

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    est = BertModel(seed=0, device="cuda")  # BERT-base, L=12 H=768 A=12
    phase("model", True,
          f"BertModel(L={est.num_layers}, H={est.hidden_dim}, "
          f"A={est.num_heads}, MLP={est.mlp_dim}, vocab={est.vocab_size}, "
          f"max_len={est.max_len}) seeded init in "
          f"{time.perf_counter() - t0:.1f}s")

    flash_inputs = check_flash(attention, gen)
    bwd_res = check_flash_bwd(attention, gen)
    tree = convert.flax_tree(est.module)
    leaves = {
        "/".join(p): t for p, t in _flat(tree)
        if t.dim() >= 2 and t.numel() >= 4096
    }
    quant_res = check_quant(quant, leaves, gen)

    grad_res = check_train_vs_cpu(est)
    train_res = run_training(est, attention)
    try:
        train_prof = profile_train_step(est, train_res["x"], train_res["y"])
    except Exception as exc:  # noqa: BLE001 — where CUPTI tracing is
        # unavailable this breakdown is reported as not measured.
        train_prof = {"not_measured": repr(exc)}

    # The trained model is what the serving path saves and serves.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        slice_res = run_slice(est, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cold = cold_start(est, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    timing = time_kernels(flash_inputs, quant_res["mats"], est)
    bwd_times = time_bwd(attention, bwd_res)

    # The zoo's paths, after BERT's: each model trained on the card, then
    # saved as an int8 artifact (K4) and loaded back (K5); MnistCNN served.
    zoo, t_zoo = {}, time.perf_counter()
    for kind in ZOO:
        try:
            zoo[kind] = run_zoo(kind)
        except Exception as exc:  # noqa: BLE001 — the other models still
            # run; the failed phase fails the script.
            phase(f"{kind} train", False, repr(exc))
    zoo_art = {"launches": {"quantize_rowwise": 0, "dequantize_rowwise": 0},
               "max_abs_err": {"quantize": 0.0, "dequantize": 0.0}}
    resnet_quant = vision_serve = None
    if len(zoo) == len(ZOO):
        zoo_art = zoo_artifacts(zoo)
        resnet_quant = time_zoo_quant(zoo["resnet50"]["est"])
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            vision_serve = run_vision_slice(zoo["vision"]["est"],
                                            zoo["vision"]["x"], tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    zoo_s = time.perf_counter() - t_zoo

    # The REST pipeline: the same fine-tune as named async jobs.
    tmp, t_rest = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        rest = run_rest_pipeline(tmp)
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("rest pipeline", False, repr(exc))
        rest = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rest_s = time.perf_counter() - t_rest

    # Phase 9: the classical estimators at two shapes, card against CPU,
    # then the Titanic pipeline over REST with its two tunes.
    # The CPU reference runs in a child from the start; the Covertype
    # comparisons come after the Titanic pipeline, so the reference's
    # host-bound fits overlap the card's side and the pipeline.
    t_classic = time.perf_counter()
    zoo9 = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    reference = CpuReference(f"{tmp}/cpu_reference")
    try:
        titanic_zoo, covtype_zoo = zoo_shapes()
        zoo9["titanic"] = run_estimator_zoo(
            titanic_zoo, fit_card_side(titanic_zoo), reference)
        covtype_cards = fit_card_side(covtype_zoo)
        os.makedirs(f"{tmp}/rest")
        try:
            titanic = run_titanic_rest(f"{tmp}/rest")
        except Exception as exc:  # noqa: BLE001 — reported as the phase's
            # failure, which fails the script.
            phase("titanic rest", False, repr(exc))
            titanic = {"launches": {}, "line": {"error": repr(exc)}}
        zoo9["covtype"] = run_estimator_zoo(covtype_zoo, covtype_cards,
                                            reference)
        del titanic_zoo, covtype_zoo, covtype_cards
    finally:
        reference.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    classic_s = time.perf_counter() - t_classic

    # Phase 10: the crash drill (kill -9 mid-fit, boot recovery, resume).
    tmp, t_drill = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        drill = run_crash_drill(tmp)
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("crash drill", False, repr(exc))
        drill = {"line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    drill_s = time.perf_counter() - t_drill

    # Phase 11: the text pipeline and beyond-RAM datasets over REST.
    tmp, t_text = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        text = run_text_pipeline(tmp, train_res["train"]["step_ms"])
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("text pipeline", False, repr(exc))
        text = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    text_s = time.perf_counter() - t_text

    # Phase 12: data-parallel training over REST and through the trainer.
    tmp, t_dist = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        dist = run_distributed(tmp, train_res["train"]["step_ms"])
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("distributed", False, repr(exc))
        dist = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dist_s = time.perf_counter() - t_dist

    # Phase 13: the decoder LM (GPT-2 small widths) and streaming
    # generation.
    tmp, t_dec = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        dec = run_decoder(tmp, card)
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("decoder", False, repr(exc))
        dec = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dec_s = time.perf_counter() - t_dec

    # Phase 14: fleet serving, last: a replica holds the card, so it runs
    # after every phase that trains.
    tmp, t_fleet = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        fleet = run_fleet(tmp, card, slice_res["artifact"],
                          dec.get("artifact"))
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("fleet", False, repr(exc))
        fleet = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fleet_s = time.perf_counter() - t_fleet

    # Phase 15: the program cache and the cost plane, after phase 14's
    # serving traffic; its decode leg serves phase 13's artifact.
    tmp, t_pc = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        if "artifact" not in dec:
            raise RuntimeError("phase 13 left no decoder artifact")
        pcache = run_program_cache(tmp, card, dec)
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("program cache", False, repr(exc))
        pcache = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pc_s = time.perf_counter() - t_pc

    # Phase 16: durable warm start (two child processes over one program
    # store) and a live profiler capture of the serving path.
    tmp, t_ws = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        if "artifact" not in dec:
            raise RuntimeError("phase 13 left no decoder artifact")
        warm = run_warm_start(tmp, card, slice_res["artifact"],
                              dec["artifact"])
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("warm start", False, repr(exc))
        warm = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ws_s = time.perf_counter() - t_ws

    # Phase 17: the mixture-of-experts models, fitted over REST, int8
    # artifacts, /predict and graph-decoded /generate streams.
    tmp, t_moe = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        moe = run_moe(tmp, card)
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("moe", False, repr(exc))
        moe = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    moe_s = time.perf_counter() - t_moe

    # Phase 18: long-context training over the sequence-parallel ring,
    # its REST path, the int8 artifact and /predict.
    tmp, t_long = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        long = run_long_context(tmp, card)
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("long context", False, repr(exc))
        long = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    long_s = time.perf_counter() - t_long

    # Phase 19: expert parallelism and the data-parallel MoE fit, its REST
    # path, the int8 artifact and /generate.
    tmp, t_ep = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        ep = run_expert_parallel(tmp, card)
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("expert parallel", False, repr(exc))
        ep = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ep_s = time.perf_counter() - t_ep

    # Phase 20: the operations plane (preemption and resume, trace,
    # metrics, a serving fault, an SLO with its bundle, overheads).
    tmp, t_ops = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        ops = run_operations_plane(tmp, card, dec["line"])
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("operations plane", False, repr(exc))
        ops = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ops_s = time.perf_counter() - t_ops

    # Phase 21: the process a user starts (python -m ... serve), behind
    # the gateway, with the lock witness on.
    tmp, t_entry = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        entry = run_entry_point(tmp, card, slice_res["artifact"])
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("entry point", False, repr(exc))
        entry = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    entry_s = time.perf_counter() - t_entry

    # Phase 22: two engines over one store (claims, steal, fence, tenant
    # quotas), a warm standby that promotes, and the native store.
    tmp, t_cp = tempfile.mkdtemp(prefix="chip_smoke_"), time.perf_counter()
    try:
        cp = run_control_plane(tmp, card, ops["line"])
    except Exception as exc:  # noqa: BLE001 — reported as the phase's
        # failure, which fails the script.
        phase("control plane", False, repr(exc))
        cp = {"launches": {}, "line": {"error": repr(exc)}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cp_s = time.perf_counter() - t_cp
    cp_l = cp["launches"]
    entry_l = entry["launches"]
    ops_l = ops["launches"]
    # bf16 K1-K3 and K4 in the preempted fit and its twin, K5 at the
    # load, f32 K1 in the served predicts.
    ops_train = [ops_l.get("fit"), ops_l.get("twin")]
    ep_l = ep["launches"]
    # bf16 K1-K3 in every rank of the dp 2 x ep 2 fit and of the REST
    # {"ep": 2} fit, K4 at the publication, K5 at the load.
    ep_train = list(ep_l.get("fit_ranks", [])) + list(
        ep_l.get("rest_ranks", []))
    long_l = long["launches"]
    # bf16 K1-K3 in every rank of the two sp = 2 fits, K4 at the
    # publication, K5 at the load, f32 K1 in the /predict dispatches.
    long_train = list(long_l.get("fit_ranks", [])) + list(
        long_l.get("rest_ranks", []))
    moe_l = moe["launches"]
    # bf16 K1-K3 in the two fits (and K1 in the bf16 forward), f32 K1 in
    # the card-vs-CPU forward and the classifier's serving, K4 at the two
    # publications, K5 at the two loads.
    moe_train = [moe_l.get("lm_train"), moe_l.get("cls_train")]
    moe_f32 = [moe_l.get("forward_f32"), moe_l.get("cls_serve")]
    moe_k4 = [moe_l.get("lm_publish"), moe_l.get("cls_publish")]
    moe_k5 = [moe_l.get("lm_load"), moe_l.get("cls_load")]
    ws_l = warm["launches"]
    ws_live = ws_l.get("live", {})
    ws_children = ws_l.get("children", [])
    # The children's train jobs (bf16 K1-K3, K4), their serving (f32 K1,
    # K5 at the load) and decoder loads (K5); the live capture's server.
    ws_train = [c.get("ws_fit") for c in ws_children]
    ws_f32 = [c.get("serve") for c in ws_children] + [
        ws_live.get("warm"), ws_live.get("capture")]
    ws_k5 = [c.get(k) for c in ws_children
             for k in ("serve", "decoder_load")] + [ws_live.get("warm")]
    pc_l = pcache["launches"]
    pc_train = list(pc_l.get("train", [])) + [pc_l.get("tune")]
    fleet_l = fleet["launches"]
    dec_l = dec["launches"]
    dec_f32 = [dec_l.get("forward_f32"), dec_l.get("forward_f32_rope")]
    dist_l = dist["launches"]
    # Every rank's K1/K2/K3 (bf16 training), the parent's K4 (the int8
    # publication), the predict job's K5 and f32 K1.
    dist_ranks = [c for key in ("rest_train_ranks", "one_device",
                                "trainer_world2")
                  for c in dist_l.get(key, [])]
    dist_parent = [dist_l.get("rest_train_parent")]
    dist_predict = [dist_l.get("rest_predict")]
    text_l = text["launches"]
    text_train = [text_l.get("bert_stream")]
    text_bf16 = text_train + [text_l.get("bert_eval")]
    text_k5 = [text_l.get("bert_eval"), text_l.get("bert_pred")]
    drill_l = drill["line"].get("launches", {})
    drill_train = [drill_l.get("recovered_train"),
                   drill_l.get("uninterrupted_train")]
    tune_l = titanic["launches"]
    rest_l = rest["launches"]
    rest_train = list(rest_l.get("rest_train", {}).values())

    def rest_sum(kernel, paths):
        return sum(c.get(kernel, 0) for c in paths if c)

    rest_bf16 = rest_train + [rest_l.get("rest_evaluate")]
    rest_f32 = [rest_l.get("rest_predict"), rest_l.get("rest_serve")]
    rest_k5 = rest_f32 + [rest_l.get("rest_evaluate")]
    bwd_t = bwd_times["train"]
    fwd = timing["flash"]
    k1_bf16 = bwd_t["k1"]
    qt = timing["quant"]
    counts = slice_res["counts"]
    train_counts = train_res["counts"]
    path_errs = bwd_res["path_bf16"]["errs"]
    kernels = [
        # K1's two routes: f32 (split TF32) on the serving path, bf16 on
        # the training path; one launch counter, read after each path.
        {"name": "flash_fwd", "route": "cuda",
         "source": "learningorchestra_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "learningorchestra_tpu/ops/attention.py:167",
         "launches": counts["flash_fwd"] + rest_sum("flash_fwd", rest_f32)
         + rest_sum("flash_fwd", [text_l.get("bert_pred")])
         + rest_sum("flash_fwd", dist_predict)
         + rest_sum("flash_fwd", dec_f32)
         + rest_sum("flash_fwd", [fleet_l.get("fleet_predict")])
         + rest_sum("flash_fwd", [pc_l.get("serve")])
         + rest_sum("flash_fwd", ws_f32)
         + rest_sum("flash_fwd", moe_f32)
         + rest_sum("flash_fwd", [long_l.get("predict")])
         + rest_sum("flash_fwd", [ops_l.get("serve")])
         + rest_sum("flash_fwd", [entry_l.get("predict")])
         + rest_sum("flash_fwd", [cp_l.get("standby_predict")]),
         "launches_by_path": {
             "serve": counts["flash_fwd"],
             "rest_predict_and_serve": rest_sum("flash_fwd", rest_f32),
             "text_predict": rest_sum("flash_fwd",
                                      [text_l.get("bert_pred")]),
             "distributed_predict": rest_sum("flash_fwd", dist_predict),
             "decoder_full_forward": rest_sum("flash_fwd", dec_f32),
             "fleet_predict": rest_sum("flash_fwd",
                                       [fleet_l.get("fleet_predict")]),
             "program_cache_serve": rest_sum("flash_fwd",
                                             [pc_l.get("serve")]),
             "warm_start_serve_and_capture": rest_sum("flash_fwd",
                                                      ws_f32),
             "moe_forward_and_predict": rest_sum("flash_fwd", moe_f32),
             "long_context_predict": rest_sum("flash_fwd",
                                              [long_l.get("predict")]),
             "operations_plane_predict": rest_sum("flash_fwd",
                                                  [ops_l.get("serve")]),
             "entry_point_predict": rest_sum("flash_fwd",
                                             [entry_l.get("predict")]),
             "control_plane_standby_predict": rest_sum(
                 "flash_fwd", [cp_l.get("standby_predict")])},
         "max_abs_err": flash_inputs["path_f32"][4],
         "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
         "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
         "library_ms": fwd["library_ms"]},
        {"name": "flash_fwd_bf16", "route": "cuda",
         "source": "learningorchestra_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "learningorchestra_tpu/ops/attention.py:167",
         "launches": train_counts["flash_fwd"]
         + rest_sum("flash_fwd", rest_bf16) + tune_l.get("flash_fwd", 0)
         + rest_sum("flash_fwd", drill_train + [drill_l.get("evaluate")])
         + rest_sum("flash_fwd", text_bf16)
         + rest_sum("flash_fwd", dist_ranks)
         + rest_sum("flash_fwd", [dec_l.get("train")])
         + rest_sum("flash_fwd", pc_train)
         + rest_sum("flash_fwd", ws_train)
         + rest_sum("flash_fwd", moe_train + [moe_l.get("forward_bf16")])
         + rest_sum("flash_fwd", long_train)
         + rest_sum("flash_fwd", ep_train)
         + rest_sum("flash_fwd", ops_train)
         + rest_sum("flash_fwd", [cp_l.get("b")]),
         "launches_by_path": {
             "train": train_counts["flash_fwd"],
             "rest_train_and_evaluate": rest_sum("flash_fwd", rest_bf16),
             "rest_tune": tune_l.get("flash_fwd", 0),
             "crash_drill": rest_sum("flash_fwd", drill_train
                                     + [drill_l.get("evaluate")]),
             "text_train_and_evaluate": rest_sum("flash_fwd", text_bf16),
             "distributed_ranks": rest_sum("flash_fwd", dist_ranks),
             "decoder_train": rest_sum("flash_fwd", [dec_l.get("train")]),
             "program_cache_train_and_tune": rest_sum("flash_fwd",
                                                      pc_train),
             "warm_start_train": rest_sum("flash_fwd", ws_train),
             "moe_train_and_forward": rest_sum(
                 "flash_fwd", moe_train + [moe_l.get("forward_bf16")]),
             "long_context_ranks": rest_sum("flash_fwd", long_train),
             "expert_parallel_ranks": rest_sum("flash_fwd", ep_train),
             "operations_plane_train": rest_sum("flash_fwd", ops_train),
             "control_plane_stolen_fit": rest_sum("flash_fwd",
                                                  [cp_l.get("b")])},
         "max_abs_err": flash_inputs["train_bf16"][4],
         "ms": k1_bf16["ms"], "plain_ms": k1_bf16["plain_ms"],
         "bound_ms": k1_bf16["bound_ms"], "bound_by": k1_bf16["bound_by"],
         "library_ms": bwd_t["library_fwd_ms"]},
        # K4/K5 launches: the BERT serving path's plus the zoo's saves
        # and loads, each path's counters read just after it.
        {"name": "quantize_rowwise", "route": "cuda",
         "source": "learningorchestra_tpu_torch/csrc/quant.cu",
         "replaces": "learningorchestra_tpu/ops/quant.py:29",
         "launches": counts["quantize_rowwise"]
         + zoo_art["launches"]["quantize_rowwise"]
         + rest_sum("quantize_rowwise", rest_train)
         + tune_l.get("quantize_rowwise", 0)
         + rest_sum("quantize_rowwise", drill_train)
         + rest_sum("quantize_rowwise", text_train)
         + rest_sum("quantize_rowwise", dist_parent)
         + rest_sum("quantize_rowwise", [dec_l.get("publish")])
         + rest_sum("quantize_rowwise", pc_train)
         + rest_sum("quantize_rowwise", ws_train)
         + rest_sum("quantize_rowwise", moe_k4)
         + rest_sum("quantize_rowwise", [long_l.get("publish")])
         + rest_sum("quantize_rowwise", [ep_l.get("publish")])
         + rest_sum("quantize_rowwise", ops_train)
         + rest_sum("quantize_rowwise", [cp_l.get("b")]),
         "launches_by_path": {
             "serve": counts["quantize_rowwise"],
             "zoo_artifacts": zoo_art["launches"]["quantize_rowwise"],
             "rest_train": rest_sum("quantize_rowwise", rest_train),
             "rest_tune": tune_l.get("quantize_rowwise", 0),
             "crash_drill": rest_sum("quantize_rowwise", drill_train),
             "text_train": rest_sum("quantize_rowwise", text_train),
             "distributed_train": rest_sum("quantize_rowwise",
                                           dist_parent),
             "decoder_publish": rest_sum("quantize_rowwise",
                                         [dec_l.get("publish")]),
             "program_cache_train_and_tune": rest_sum("quantize_rowwise",
                                                      pc_train),
             "warm_start_train": rest_sum("quantize_rowwise", ws_train),
             "moe_publish": rest_sum("quantize_rowwise", moe_k4),
             "long_context_publish": rest_sum("quantize_rowwise",
                                              [long_l.get("publish")]),
             "expert_parallel_publish": rest_sum("quantize_rowwise",
                                                 [ep_l.get("publish")]),
             "operations_plane_publish": rest_sum("quantize_rowwise",
                                                  ops_train),
             "control_plane_stolen_fit_publish": rest_sum(
                 "quantize_rowwise", [cp_l.get("b")])},
         "max_abs_err": max(quant_res["quantize"],
                            zoo_art["max_abs_err"]["quantize"]),
         "ms": qt["quantize_grouped_ms"], "plain_ms": qt["quantize_plain_ms"],
         "bound_ms": qt["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "dequantize_rowwise", "route": "cuda",
         "source": "learningorchestra_tpu_torch/csrc/quant.cu",
         "replaces": "learningorchestra_tpu/ops/quant.py:56",
         "launches": counts["dequantize_rowwise"]
         + zoo_art["launches"]["dequantize_rowwise"]
         + rest_sum("dequantize_rowwise", rest_k5)
         + rest_sum("dequantize_rowwise", [drill_l.get("evaluate")])
         + rest_sum("dequantize_rowwise", text_k5)
         + rest_sum("dequantize_rowwise", dist_predict)
         + rest_sum("dequantize_rowwise", [dec_l.get("load")])
         + rest_sum("dequantize_rowwise", [fleet_l.get("fleet_load")])
         + rest_sum("dequantize_rowwise", [pc_l.get("serve"),
                                           pc_l.get("decoder_load")])
         + rest_sum("dequantize_rowwise", ws_k5)
         + rest_sum("dequantize_rowwise", moe_k5)
         + rest_sum("dequantize_rowwise", [long_l.get("load")])
         + rest_sum("dequantize_rowwise", [ep_l.get("load")])
         + rest_sum("dequantize_rowwise", [ops_l.get("load")])
         + rest_sum("dequantize_rowwise", [entry_l.get("load")])
         + rest_sum("dequantize_rowwise", [cp_l.get("standby_load")]),
         "launches_by_path": {
             "serve": counts["dequantize_rowwise"],
             "zoo_artifacts": zoo_art["launches"]["dequantize_rowwise"],
             "rest_evaluate_predict_serve": rest_sum("dequantize_rowwise",
                                                     rest_k5),
             "crash_drill_evaluate": rest_sum("dequantize_rowwise",
                                              [drill_l.get("evaluate")]),
             "text_evaluate_predict": rest_sum("dequantize_rowwise",
                                               text_k5),
             "distributed_predict": rest_sum("dequantize_rowwise",
                                             dist_predict),
             "decoder_load": rest_sum("dequantize_rowwise",
                                      [dec_l.get("load")]),
             "fleet_load": rest_sum("dequantize_rowwise",
                                    [fleet_l.get("fleet_load")]),
             "program_cache_loads": rest_sum(
                 "dequantize_rowwise", [pc_l.get("serve"),
                                        pc_l.get("decoder_load")]),
             "warm_start_loads": rest_sum("dequantize_rowwise", ws_k5),
             "moe_loads": rest_sum("dequantize_rowwise", moe_k5),
             "long_context_load": rest_sum("dequantize_rowwise",
                                           [long_l.get("load")]),
             "expert_parallel_load": rest_sum("dequantize_rowwise",
                                              [ep_l.get("load")]),
             "operations_plane_load": rest_sum("dequantize_rowwise",
                                               [ops_l.get("load")]),
             "entry_point_load": rest_sum("dequantize_rowwise",
                                          [entry_l.get("load")]),
             "control_plane_standby_load": rest_sum(
                 "dequantize_rowwise", [cp_l.get("standby_load")])},
         "max_abs_err": max(quant_res["dequantize"],
                            zoo_art["max_abs_err"]["dequantize"]),
         "ms": qt["dequantize_grouped_ms"],
         "plain_ms": qt["dequantize_plain_ms"], "bound_ms": qt["bound_ms"],
         "bound_by": "bytes", "library_ms": qt["dequantize_library_ms"]},
        *({"name": f"flash_bwd_{key}", "route": "cuda",
           "source": "learningorchestra_tpu_torch/csrc/flash_bwd.cu",
           "replaces": f"learningorchestra_tpu/ops/attention.py:{line}",
           "launches": train_counts[f"flash_bwd_{key}"]
           + rest_sum(f"flash_bwd_{key}", rest_train)
           + tune_l.get(f"flash_bwd_{key}", 0)
           + rest_sum(f"flash_bwd_{key}", drill_train)
           + rest_sum(f"flash_bwd_{key}", text_train)
           + rest_sum(f"flash_bwd_{key}", dist_ranks)
           + rest_sum(f"flash_bwd_{key}", [dec_l.get("train")])
           + rest_sum(f"flash_bwd_{key}", pc_train)
           + rest_sum(f"flash_bwd_{key}", ws_train)
           + rest_sum(f"flash_bwd_{key}", moe_train)
           + rest_sum(f"flash_bwd_{key}", long_train)
           + rest_sum(f"flash_bwd_{key}", ep_train)
           + rest_sum(f"flash_bwd_{key}", ops_train)
           + rest_sum(f"flash_bwd_{key}", [cp_l.get("b")]),
           "launches_by_path": {
               "train": train_counts[f"flash_bwd_{key}"],
               "rest_train": rest_sum(f"flash_bwd_{key}", rest_train),
               "rest_tune": tune_l.get(f"flash_bwd_{key}", 0),
               "crash_drill": rest_sum(f"flash_bwd_{key}", drill_train),
               "text_train": rest_sum(f"flash_bwd_{key}", text_train),
               "distributed_ranks": rest_sum(f"flash_bwd_{key}",
                                             dist_ranks),
               "decoder_train": rest_sum(f"flash_bwd_{key}",
                                         [dec_l.get("train")]),
               "program_cache_train_and_tune": rest_sum(
                   f"flash_bwd_{key}", pc_train),
               "warm_start_train": rest_sum(f"flash_bwd_{key}", ws_train),
               "moe_train": rest_sum(f"flash_bwd_{key}", moe_train),
               "long_context_ranks": rest_sum(f"flash_bwd_{key}",
                                              long_train),
               "expert_parallel_ranks": rest_sum(f"flash_bwd_{key}",
                                                 ep_train),
               "operations_plane_train": rest_sum(f"flash_bwd_{key}",
                                                  ops_train),
               "control_plane_stolen_fit": rest_sum(f"flash_bwd_{key}",
                                                    [cp_l.get("b")])},
           "max_abs_err": err, "ms": bwd_t[key]["ms"],
           "plain_ms": bwd_t[key]["plain_ms"],
           "bound_ms": bwd_t[key]["bound_ms"],
           "bound_by": bwd_t[key]["bound_by"],
           "library_ms": bwd_t["library_bwd_ms"]}
          for key, line, err in (("dq", 245, path_errs[0]),
                                 ("dkv", 297, max(path_errs[1:])))),
    ]
    try:
        prof = profile_forward(est)
    except Exception as exc:  # noqa: BLE001 — where CUPTI tracing is
        # unavailable this breakdown is reported as not measured.
        prof = {"not_measured": repr(exc)}
    print("profile " + json.dumps(prof), flush=True)
    print("train_profile " + json.dumps(train_prof), flush=True)
    print("train " + json.dumps({**train_res["train"], **grad_res,
                                 "counts": train_counts}), flush=True)
    print("bwd_timing " + json.dumps(bwd_times), flush=True)
    print("fwd_timing_f32 " + json.dumps(fwd), flush=True)
    q, k, v, _, _ = flash_inputs["path_f32"]
    try:
        sdpa = sdpa_kernel_names(q, k, v)
    except Exception as exc:  # noqa: BLE001 — as for the profiles above
        sdpa = {"not_measured": repr(exc)}
    print("sdpa_f32_kernels " + json.dumps(sdpa), flush=True)
    print(f"launches by path: train {train_counts}, serve {counts}; "
          "flash_fwd is K1's f32 route at the serving shape (launches: the "
          "serving path), flash_fwd_bf16 its bf16 route at the fine-tune "
          "shape (launches: the training path); "
          "library_ms of flash_bwd_dq and flash_bwd_dkv is ONE number: the "
          "backward of scaled_dot_product_attention (bf16, boolean mask), "
          "which computes K2 and K3's outputs together", flush=True)
    serve = slice_res["serve"]
    serve["forward_ms_bucket64"] = timing["forward_ms"]
    serve["flash_share_of_forward"] = 12 * fwd["ms"] / timing["forward_ms"]
    print("serve " + json.dumps(serve), flush=True)
    print("cold_start " + json.dumps(cold), flush=True)
    print("timing shapes: flash_bwd (B,H,T,D)=" + str(TRAIN_SHAPE)
          + f" bf16, dq {bwd_t['dq']['flops'] / 1e9:.2f} GFLOP "
          f"{bwd_t['dq']['bytes'] / 1e6:.1f} MB, dkv "
          f"{bwd_t['dkv']['flops'] / 1e9:.2f} GFLOP "
          f"{bwd_t['dkv']['bytes'] / 1e6:.1f} MB (bounds at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, "
          f"{PEAK_BYTES / 1e12} TB/s); flash fwd (B,H,T,D)=" + str(PATH_SHAPE)
          + f" f32, {fwd['flops'] / 1e9:.2f} GFLOP (x3 in TF32 at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s), {fwd['bytes'] / 1e6:.1f} "
          f"MB; "
          f"quantize/dequantize = every quantized leaf of the artifact "
          f"once ({qt['bytes'] / 1e6:.1f} MB each way) in one grouped "
          f"launch; kernel ms are device time (launches queued behind a "
          f"device sleep)", flush=True)
    print("quant_timing " + json.dumps(qt), flush=True)
    for kind, run in zoo.items():
        print(f"zoo_train {kind} " + json.dumps(run["result"]), flush=True)
    print("zoo_artifacts " + json.dumps(
        {k: v for k, v in zoo_art.items() if k in ZOO or k == "launches"}),
        flush=True)
    print("resnet50_quant_timing " + json.dumps(resnet_quant), flush=True)
    print("vision_serve " + json.dumps(vision_serve), flush=True)
    name, _, limit = card.partition(",")
    print("rest_pipeline " + json.dumps({
        "card": name.strip(), "power_limit": limit.strip(),
        **rest["line"]}), flush=True)
    for shape, lines in zoo9.items():
        print(f"estimators_{shape} " + json.dumps(lines, default=float),
              flush=True)
    print("titanic_rest " + json.dumps({
        "card": name.strip(), "power_limit": limit.strip(),
        **titanic["line"]}), flush=True)
    print("crash_drill " + json.dumps({
        "card": name.strip(), "power_limit": limit.strip(),
        **drill["line"]}), flush=True)
    print("text_pipeline " + json.dumps({
        "card": name.strip(), "power_limit": limit.strip(),
        **text["line"]}, default=str), flush=True)
    print("distributed " + json.dumps({
        "card": name.strip(), "power_limit": limit.strip(),
        **dist["line"]}, default=str), flush=True)
    print("decoder " + json.dumps(dec["line"], default=str), flush=True)
    print("fleet " + json.dumps(fleet["line"], default=str), flush=True)
    print("program_cache " + json.dumps(pcache["line"], default=str),
          flush=True)
    print("warm_start " + json.dumps(warm["line"], default=str), flush=True)
    print("moe " + json.dumps(moe["line"], default=str), flush=True)
    print("long_context " + json.dumps(long["line"], default=str),
          flush=True)
    print("expert_parallel " + json.dumps(ep["line"], default=str),
          flush=True)
    print("operations_plane " + json.dumps(ops["line"], default=str),
          flush=True)
    print("entry_point " + json.dumps(entry["line"], default=str),
          flush=True)
    cp_line = cp["line"]
    cp_common = {"card": cp_line.get("card"), "error": cp_line.get("error")}
    print("control_plane " + json.dumps({**cp_common, **{
        k: cp_line.get(k) for k in (
            "engines_boot_s", "engine_epochs", "b_capture_start_s",
            "a_first_checkpoint_s", "steal_s", "resume_to_finished_s",
            "epochs_on_b", "losses", "twin_losses", "loss_rel_err",
            "b_capture")}}, default=str), flush=True)
    print("store_ha " + json.dumps({**cp_common, **{
        k: cp_line.get(k) for k in (
            "standby_armed_s", "takeover_s", "acknowledged_writes",
            "lost_writes", "standby_capture_start_s", "standby_capture",
            "standby_dispatches", "standby_vs_b_max_abs",
            "revived_exit_s", "standby_exit", "seconds")}}, default=str),
          flush=True)
    print("native_store " + json.dumps({**cp_common, **(
        cp_line.get("native_store") or {})}, default=str), flush=True)
    print(f"smoke_seconds {time.perf_counter() - T_START:.1f} (zoo phases "
          f"{zoo_s:.1f}, rest pipeline {rest_s:.1f}, classical estimators "
          f"and the Titanic pipeline {classic_s:.1f}, crash drill "
          f"{drill_s:.1f}, text pipeline {text_s:.1f}, distributed "
          f"{dist_s:.1f}, decoder {dec_s:.1f}, fleet {fleet_s:.1f}, "
          f"program cache {pc_s:.1f}, warm start {ws_s:.1f}, moe "
          f"{moe_s:.1f}, long context {long_s:.1f}, expert parallel "
          f"{ep_s:.1f}, operations plane {ops_s:.1f}, entry point "
          f"{entry_s:.1f}, control plane {cp_s:.1f})", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


if __name__ == "__main__":
    if sys.argv[1:2] == ["--crash-drill-child"]:
        sys.exit(crash_child(sys.argv[2]))
    if sys.argv[1:2] == ["--cpu-reference"]:
        sys.exit(cpu_reference_child(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--aot-child"]:
        sys.exit(aot_child(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--ring-child"]:
        sys.exit(ring_child(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--ep-child"]:
        sys.exit(ep_child(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
