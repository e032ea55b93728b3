#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py [--seed N] [--requests N] [--train-steps N]
                          [--generate-requests N] [--table-out PATH]

Phases (any failure raises and the script exits non-zero):

  1. setup — print the card and its power limit, turn TF32 off, build the
     CUDA sources from ``tpu_pipelines_torch/csrc`` (one nvcc each, all
     started together) and print the build times;
  1a. native_cores — build the host cores ``csrc/host/record_core.cc``
     and ``tokenizer_core.cc`` (one g++ each, started together), hold the
     C crc32c against the table version on CRC_BYTES seeded bytes and the
     check value crc32c(b"123456789") = 0xE3069283, and print both rates;
     parse a seeded stream of PARSE_CHUNKS record chunks, the first in
     Python (it pins the schema) and the rest by the core, against the
     Python parse of every chunk; the bert_dag and retrain_dag phases then
     read the cores' counters (``check_host_cores``): every crc through C,
     no record chunk refused by the core, every review row encoded by it;
  2. kernels — print the forward, backward and decode kernels' registers,
     spills and shared memory per instantiation (the decode kernel's also
     at each timed shape: its splits S, the cluster size and the clusters
     the card holds at once); hold each kernel against its plain PyTorch
     version on the card at its main path's shapes and at edge cases
     (ragged length, causal, an all-masked batch row, a masked 64-key block
     inside a row, fp16/f32, strided inputs, the decode kernel's arena
     slices, int32, bool and batch-stride-0 bool masks, L = 1, split-KV
     shapes with uneven spans, all-masked splits and clusters of 2 to 8,
     and a 4096-key cache), and time it beside its plain version, the
     one-call PyTorch yardstick and its bound (the forward at the serving,
     the training and the BERT DAG's shapes, the backward kernels and Dvec
     at the training and the BERT DAG's shapes, the decode kernel at the
     beam-served, the long-cache (B=32 and B=4, L=4096), the long engine
     bucket's and the T5 DAG's BulkInferrer shapes); the forward and
     backward kernels also against a control (fed the mask shifted by one
     key) that must miss; every kernel repeated bit for bit; hold the
     attention's gradients against autograd through dense attention in
     f32;
  2b. crossover — with ``TPP_AUTOTUNE_CACHE`` pointed at a directory of
     the run's own, time the gradient of sum(attention) through the flash
     kernels against the port's dense attention (B=8, H=12, D=64, bf16) at
     L = 64, 128, 512, 2048, 8192 (flash alone where dense does not fit),
     and the decode kernel against dense cache attention (B=32, H=8, D=64)
     at 32, 128, 512, 2048, 8192 keys; print both tables and record each
     crossover (the first length where flash is no slower) for this card,
     which "auto" attention reads from here on (``--table-out`` writes
     them as a committed-table file);
  3. serving — export a BERT-base payload (full width, random weights from
     ``--seed``) with flash attention, serve it with ``ModelServer`` on the
     card with micro-batching, send concurrent REST ``:predict`` requests,
     and check every reply against the same weights served with dense
     attention (and that a wrong key mask would fail that check), and that
     every device batch launched the flash kernel once per layer;
  4. generate — export a T5-small payload (full width, random weights from
     ``--seed``, flash decode, beam 4, 128 decode steps, eos 3), serve it
     with ``ModelServer`` on the card, send ``:generate`` requests of 1-4
     rows from 8 concurrent clients: every reply 200 with [rows, 128] ids,
     the decode kernel launched once per decoder layer and pass, the
     teacher-forced logits of the served tokens against dense decode
     attention (and two controls around the kernel outside that
     tolerance); report latency, tokens/s and a profiled decode step;
  5. fleet — the serving fleet.  BERT-base (the serving phase's payload)
     behind ``ModelServer(replicas=2, max_versions=2, slo_p99_ms=50,
     max_batch_size=32)`` with the supervisor on: a pushed version's
     canary and warm-up capture one CUDA graph per padded bucket (6, none
     eager), each bucket's replay equal to the eager step bit for bit; a
     client run whose replies sit within LOGIT_TOL of dense attention
     (two wrong-mask controls above), flash_fwd launched 12 x device
     batches (credited per replay), no compile after warm-up; a hot swap
     under load with every reply 200, a push of NaN weights answered 409,
     and KILL_REPLICA on replica 0, ejected and rebuilt while every reply
     stays 200.  Then T5-small as the generative model type (2 replicas,
     engine batch 8, pages of 32): every (batch, kv) bucket's step
     captured at warm-up in each engine, ``:generate`` with
     ``max_new_tokens`` from 8 clients all 200, flash_decode launched 6 x
     (prefills + steps), no compile after warm-up, the captured engine's
     streams equal to the eager engine's on one schedule, an over-budget
     burst answered 429; report warm seconds, graph memory,
     examples/s, p50/p99, steps/s and the idle share of a replayed
     predict and engine step against the eager ones;
  6. engine — the continuous-batching ``GenerativeEngine`` over the same
     payload (batch 8, pages of 32), warmed, then 24 sequences with ragged
     prompts and budgets from threads: every stream ends at EOS or its
     budget, one kernel launch per layer per prefill and step, no bucket
     first run after warm(); report steps/s, tokens/s, occupancy and how
     many streams equal the isolated greedy decode;
  7. engine_long — the engine over the same weights at a 2048-key cache
     (kv buckets 256/512/1024/2048), 8 sequences with budgets of 1100-1400
     tokens from threads, submitted LONG_STAGGER steps apart: every stream
     ends, one kernel launch per layer per prefill and step, the 2048
     bucket runs, no bucket first run after warm(); one step of the 2048
     bucket (its deepest row past 1024 keys, the rows at ragged positions)
     is replayed from a copy of its inputs with dense decode attention (its
     logits within DECODE_LOGIT_TOL of the kernel's step), with each decode
     call held against the plain version (within OUT_TOL), and under two
     controls around the kernel (the validity one short; the split that
     holds the current position lost), each of which must miss OUT_TOL at
     the attention output (the split lost also DECODE_LOGIT_TOL at the
     logits); report steps/s and tokens/s;
  7b. engine_levers — the engine's decode levers on the same payload at
     the engine phase's shapes, LEVER_SEQS sequences from 8 threads (the
     last LEVER_REPEATS repeat earlier prompts): lever-off; the prefix
     cache with chunked prefill (hits = the repeats, no prefill for a
     hit); self-draft speculative decoding at k = LEVER_SPEC (the draft
     lane's step graphs and the verify windows captured at warm-up); a
     per-token SLO under hard_deadline at LEVER_TIGHT of the lever-off
     step (streams evicted) and at LEVER_LOOSE times it (none evicted).
     Every run: no compile after warm-up, every finished stream ends at
     EOS or its budget, every emitted token the target's greedy choice
     when the streams are fed back through the decode contract (within
     DECODE_LOGIT_TOL; a swapped token above it), flash_decode launched
     6 x (prefill passes + target and draft step replays), the verify
     windows (dense) none; report tokens/s, per-token p50/p99,
     acceptance, hits, evictions and the launches by program;
  8. training — fine-tune BERT-base (full width, bf16, dropout 0.1, random
     init from ``--seed``) through ``train_loop`` at batch 256 x 128 with
     ragged lengths, the first step eager and every later one a replay of
     one captured CUDA graph: every loss finite, each of the four
     attention kernels (forward, Dvec, dq, dk/dv) launched once per layer
     and step (counted at replay), one capture and a replay for every
     step after the first, no compile after warm-up; the losses and final
     q/k/v weights equal, bit for bit, to the same steps run eagerly (and
     a control re-seeded with the previous step's seed that differs); a
     last batch of another size captured once more (one compile after
     warm-up); the first step's q/k/v projection gradients, the loop's
     AdamW first moment of those weights after its last step, and every
     step's loss within tolerance of the same run with dense attention
     (and two wrong-mask controls outside each); report examples/s/chip
     of two graph runs and the eager steps, MFU, peak memory of graph and
     eager, the captured AdamW update fused and foreach, and a profiled
     step, eager and replayed;
  8a. moe_train — BERT-base-MoE (the Switch-Base-8 layout: 8 experts on
     the odd layers, capacity factor 1.25) fine-tunes as the training
     phase does (batch 256 x 128 ragged, bf16, dropout 0.1, fused AdamW,
     12 steps in windows of 4, the first eager, then one capture and
     replays) with the reference's loss, task + 0.01 x the load-balancing
     loss of ``apply_with_moe_aux``: finite losses, ``moe_aux`` >= 1, each
     attention kernel launched 12 x steps (counted at replay), the graph
     run's losses and expert weights equal to the same steps run eagerly
     bit for bit; the trained layer-1 MoE block on the card against the
     same block in f64 on the CPU (MOE_BLOCK_TOL; routing every token to
     its second-best expert must miss it), its kept and dropped shares and
     tokens per expert; report examples/s/chip, MFU from counted FLOPs,
     peak memory and a replayed step's device ms by kind (GEMM, attention,
     routing and other);
  8a'. moe_serving — that payload exported through the BERT module and
     served by ``ModelServer`` from the boot version's bucket graphs: each
     bucket's replay == eager bit for bit, 12 forward launches a device
     batch credited per replay, 0 compiles after warm-up; the eager flash
     step within LOGIT_TOL of dense attention under the flash step's
     routing (the two wrong-mask controls above it); every served row
     within LOGIT_TOL of the eager flash step on its own input (the
     replies shifted by one row must miss it);
  8b. dp_train — data-parallel training (A5).  (a) A world of one over
     NCCL (a process group made here over a FileStore): BERT-base at full
     width and DP_LAYERS layers, batch DP_BATCH x SEQ_LEN, dropout 0,
     DP_STEPS steps in each of the implicit mode, psum_bucketed at
     accumulation 1 and 2, ordered
     (G = DP_BLOCKS, accumulation 2) and fsdp (every parameter sharded on
     dim 0): one capture and a replay a step each, with collectives issued
     inside the capture; the four attention kernels launched layers x
     forwards a step x steps; losses within DP_LOSS_TOL and parameter
     changes within DP_CHANGE_TOL of the single-device loop's (a planted
     fault, every second micro-batch's gradient dropped, must miss the
     latter); ordered's replay == its eager steps bit for bit;
     fsdp within DP_GRAD_TOL of psum; report examples/s per mode and the
     collective share of profiled replays.  (c) ResNet-50, psum_bucketed,
     accumulation 2, sync-BN: replay == eager bit for bit with the running
     statistics.  (b) Two ranks on the one card over gloo (spawned; NCCL
     refuses two ranks on one device, and gloo's steps run eagerly):
     every mode equal on both ranks; the ordered run (DP_TWO_LAYERS
     layers) equal bit for bit to a captured world of one over NCCL; the
     two ranks stopped after 3 steps past their checkpoint at 2 and the
     survivor resumed at a world of one, replaying 1 step, equal bit for
     bit to the uninterrupted run; ResNet-50's BatchNorm buffers after a
     step equal on both ranks and to the mean of each rank's own
     statistics;
  8c. seq_expert_two_ranks — sequence and expert parallelism (A6a) on two
     gloo ranks of the one card (spawned; NCCL refuses two ranks on one
     device, gloo carries ``all_to_all_single`` with uneven splits, by the
     probe), deterministic cuBLAS, dropout 0, 3 SGD steps each, against
     one process running the same steps: BERT-base (SP_EP_LAYERS layers)
     at 4 x 2048 over seq = 2 with ``long_context_batch_partition``, ring
     and then Ulysses (f32 compute on both sides; one process runs flash),
     and BERT-base-MoE (SP_EP_LAYERS layers) at 32 x 128 over expert = 2
     (one process runs all 8 experts): losses and
     parameter changes within SP_* / EP_* on both ranks, a control that
     must miss the change tolerance (rank 0 drops the block of its last
     ring hop; rank 1's partial output left out of the combine); both
     ranks hold one model bit for bit (shared gradients averaged over
     seq and expert); each rank's own launches, counted from zero a job:
     none for ring and Ulysses, SP_EP_LAYERS x 3 of each training kernel for EP;
  8d. tp_pp_two_ranks — tensor and pipeline parallelism (A6b) on two gloo
     ranks of the one card (spawned, as 8c), deterministic cuBLAS, dropout
     0, 3 SGD steps each against one process: BERT-base (vocabulary
     30,522) at 32 x 128 over model = 2 with flash attention and
     ``bert_partition_rules``, in f32 compute on both sides (TP_*
     tolerances; a control leaving layer 0's attention-output reduction
     out must miss the change tolerance) and in bf16 (the tensor-core
     kernels' launches, the ranks equal); each rank launches
     TP_LAYERS x 3 of each training kernel, holds half the heads, MLP columns and
     vocabulary, and both ranks hold one model bit for bit;
     ``bert_module.run_fn`` on that mesh at dropout 0.1 (the ranks equal,
     rank 0's payload loaded with no mesh within LOGIT_TOL of the gathered
     model); the staged classifier at BERT width (2 stages x 6 layers, 8
     microbatches of 32, f32) over pipe = 2 against its stages in order in
     one process (PP_* tolerances; a control handing stage 1 the previous
     tick's microbatch must miss), each rank holding its stage, the
     payload both and predicting within PP_LOGIT_TOL; report each step's
     time over gloo against one process; then the staged DAG twin through
     ``python -m tpu_pipelines_torch run`` at its defaults (one process:
     the reference's fallback, the stages in order), every node COMPLETE,
     a rerun all cache hits, no launch;
  8e. t5_moe_two_ranks — T5 and the MoE experts on the other mesh axes
     (A6c) in the same spawn of two gloo ranks, each job against one
     process with a control that must miss: T5-small (vocabulary 32,128,
     T5_TP_LAYERS + T5_TP_LAYERS layers, f32) at 32 x 128 over model = 2
     with ``t5_partition_rules`` (T5_CHANGE_TOL and TP_LOSS_TOL, beside a
     one-process f64 run as the witness of f32's own rounding; control:
     layer 0's attention-output reduction left out), and at dropout 0.1
     (the ranks draw one process's masks; control: each rank draws its
     columns' mask alone); T5-small decoding over model = 2 in bf16
     (T5_DECODE_LAYERS + T5_DECODE_LAYERS layers): greedy, 32 tokens for
     8 prompts into a 2048-key cache, and beam 4 for 4 of them, each
     step's logits (greedy) and log-probabilities (beam) within
     DECODE_LOGIT_TOL of one process through a row's first parting step,
     which must be a near-tie (control: the reduction left out, greedy
     and beam each missing), each rank launching flash_decode on its 4
     heads; T5-small at 4
     x 1024 split over seq = 2 (SP_* tolerances; control: cross-
     attention's gather over seq left out); BERT-base-MoE (SP_EP_LAYERS
     layers, f32, flash) with its experts' d_ff over model = 2 (EP_*
     tolerances; control: layer 1's expert-output reduction left out),
     each rank launching SP_EP_LAYERS x 3 of each training kernel on its
     6 heads; the T5 training jobs launch none (T5's biased attention is
     dense, as the reference's);
  8f. spmd_dag — multi-process runs (A10) in the same spawn: a BERT-base
     DAG (SPMD_PIPELINE: CsvExampleGen -> StatisticsGen -> SchemaGen ->
     Transform -> Trainer, ``bert_module.run_fn`` at BERT-base's width,
     DP_TWO_LAYERS layers, its own vocabulary, flash, ``mesh {"data": 2}``)
     whose manifests ``GPUJobRunner`` emits (one host of two GPUs); the
     upstream nodes run through ``run_node.main`` with their container
     templates' argv, one partial run each; the Trainer once in this
     process at a world of one on a copy of the root and store, then on
     the two ranks with its JobSet container's argv and env (the
     completion index and torchrun's variables filled in), three times:
     (i) a failure planted in rank 1's attempt after its collectives
     fails the node on both within SPMD_FAIL_S, one FAILED execution, no
     cache entry; (ii) the retry executes: one COMPLETE execution
     published by rank 0, one shared model dir with the payload, each
     rank DP_TWO_LAYERS x SPMD_STEPS launches of every training kernel,
     the ranks one model bit for bit, losses within DP_LOSS_TOL and
     changes within DP_CHANGE_TOL of one process, the payload's logits the
     trained model's; (iii) CACHED on both with no launch;
  9. taxi_dag — the Chicago-taxi DAG (all nine nodes of
     ``tpu_pipelines_torch/examples/taxi_pipeline.py``) through
     ``LocalDagRunner(device="cuda")`` over a CSV of TAXI_ROWS rows made
     from ``--seed`` (the value ranges and categories of
     tests/testdata/taxi_sample.csv, empty hour and company fields), 200
     steps at batch 32: every node COMPLETE, the Evaluator and the
     InfraValidator bless, the Pusher pushes; a rerun is all cache hits;
     the Transform ran on the card, where the first chunk of each split
     equals apply_host bit for bit but for log_fare_z (within its log1p
     bound), and a graph with every z-score mean shifted by one std misses
     that bound; the card's float64 analyzer states equal numpy's within
     1e-12; the Trainer's losses are finite, its exported params were on
     the card, no capture after warm-up; the pushed payload predicts raw
     rows on the card within 1e-5 of the CPU, and the Evaluator's metrics
     equal the same evaluation on the CPU within 1e-5; report each node's
     wall time, Transform rows/s on the card and apply_host, a profiled
     chunk's idle share, training and evaluation examples/s.  The DAG
     launches none of the attention kernels;
 10. bert_dag — the BERT-base fine-tune DAG (the six nodes of
     ``tpu_pipelines_torch/examples/bert_pipeline.py``: CsvExampleGen ->
     StatisticsGen -> SchemaGen -> Transform (tokenize) -> Trainer ->
     Evaluator) as a user runs it, ``python -m tpu_pipelines_torch run
     --pipeline-module .../bert_pipeline.py`` (called in this process) at
     BERT_BASE (batch 256, lr 2e-5, sequences of the tokenizer's 64), the
     twin's own ``attn_impl "auto"`` deciding by the crossover just
     measured, 100 steps, over BERT_DAG_ROWS made-up reviews from
     ``--seed``: every node COMPLETE, a rerun all cache hits with no
     launch; the counters, read from inside the runner, hold what the
     crossover implies (flash: each backward kernel at 12 x 100 and the
     forward at 12 x (100 + the Trainer's eval batches + the
     Evaluator's); dense: none); the run telemetry server
     (``TPP_METRICS_PORT``) scraped once during the cold run for the
     ``pipeline_nodes_*`` gauges and ``pipeline_run_info``; ``trace
     latest --json --perfetto --metrics`` after each run: a node span for
     every node, a critical path, cache-hit ratio 0.0 cold and 1.0 warm,
     the Trainer's goodput and telemetry summaries with no compile after
     warm-up, both files parse; ``inspect runs --json`` lists both runs;
     each checkpoint's seconds the loop was blocked and the thread's write
     seconds; one capture, a replay a step, no compile after warm-up; the
     Transform's first chunk of each split on the card == apply_host bit
     for bit; the payload's predict of raw rows == predict_transformed of
     the materialized rows bit for bit; the Evaluator's logits, loss and
     accuracy on two batches against the same payload with dense
     attention (bounds from LOGIT_TOL), a shifted-mask control missing
     it; report node seconds, the trace's critical path and the
     recorder's cost, tokenize rows/s, examples/s over the run, evaluation
     examples/s and accuracy, a replayed step's idle share;
 11. t5_dag — the T5-small seq2seq DAG (``examples/t5_pipeline.py``, its
     BulkInferrer beam-decoding the raw eval split, beam 4, 32 steps,
     batch 64) at T5_SMALL with ``attn_impl "auto"``, T5_DAG_STEPS steps, over
     T5_DAG_PAIRS made-up pairs: every node COMPLETE, a rerun all cache
     hits; the Trainer (dense: T5's self-attention carries a relative
     bias) launches nothing, one capture, no compile after warm-up; one
     prediction row of 32 ids per eval row, in the input's order; the
     decode kernel launched as the decode crossover implies (flash: 6
     layers x 32 passes x batches; dense: none); the first and last batch
     decoded again from raw rows (the payload's embedded transform) ==
     from the materialized rows == the node's rows; where the kernel
     decodes, the first batch's teacher-forced logits against dense
     decode attention within DECODE_LOGIT_TOL, the two controls outside
     it;
 12. retrain_dag — retraining against production at BERT_BASE through
     the CLI: RETRAIN_PIPELINE (ImportExampleGen over TFRecord spans of
     made-up reviews, ``{SPAN}``, every crc checked -> StatisticsGen ->
     SchemaGen -> Transform with the production model's vocabulary; an
     Importer of the bert_dag phase's model warm-starting the Trainer,
     RETRAIN_STEPS steps; a latest-blessed Resolver as the Evaluator's
     baseline; the Pusher inside ``Cond(deploy == True)``).  Run 1 (span
     1, deploy): the Resolver resolves nothing, the Evaluator blesses on
     its value threshold, the Trainer starts from the imported weights bit
     for bit, the push carries ``training_statistics_uri``.  Run 2 (span 2
     added, no deploy): re-ingested, run 1's model resolved by artifact
     id and evaluated as the baseline, the Pusher COND_SKIPPED, nothing
     pushed.  A warm rerun: every executor node a cache hit, no launch, the
     Resolver run again, the skip replayed.  Launches read inside the
     runner (12 x steps each backward kernel; 12 x (steps + the Trainer's
     eval batches + the Evaluator's passes x batches) forwards), the
     candidate's logits against dense attention with a shifted-mask
     control; report node seconds, ingest rows/s, losses, accuracy;
 13. fleet_guard — the BERT fleet of phase 5 with the post-deploy guards
     (SLO monitor every GUARD_MONITOR_S, every request sampled into
     GUARD_WINDOW_S drift windows, TPP_SWAP_PROBATION_S=GUARD_PROBATION_S):
     boots on the production model (its first batch captures its
     buckets; flash_fwd 12 x batches), hot-swaps under load to run 1's
     pushed payload (captured at its canary); a control window of unseen
     reviews scores quiet against the payload's training statistics, a
     flood of GUARD_CAMPAIGN texts breaches skew, ``python -m
     tpu_pipelines_torch drift`` reports both; DEVICE_ERROR on every
     replica makes the 5xx burn breach inside the probation window: the
     fleet rolls back to the production model (its graphs replay, nothing
     captured, each bucket == eager bit for bit), counts it, quarantines
     the new version (``:reload`` 409, listed in ``health()``), and
     ``clear_quarantine`` re-admits it; a breach after the re-admitting
     swap's probation ran out rolls nothing back.  Every reply outside the
     fault is 200 and within LOGIT_TOL of dense attention (a wrong-mask
     control above); report the boot's p50, slowest reply and replies
     over the SLO, the monitor's latency burn at the swap and at the
     rollback, the seconds from the first bad reply to the rollback, and
     served examples/s over alternating rounds with the sampler on and
     off;
 14. continuous — the continuous controller (A23) in this process, from
     CONTINUOUS_PIPELINE's ``create_continuous`` with a state dir: TFRecord
     spans of CONT_ROWS reviews land under ``data/span-{SPAN}/v-{VERSION}``;
     the span pipeline (ImportExampleGen -> StatisticsGen with its
     accumulators, node deadlines) runs once per new span; the window
     pipeline (RollingWindowResolver over CONT_WINDOW spans -> SpanWindow /
     WindowStatisticsMerger -> SchemaGen -> Transform with the production
     vocabulary -> Trainer at BERT_BASE, "auto" attention, CONT_STEPS steps
     warm-started from an Importer of the bert_dag model -> Evaluator
     against the resolver's baseline -> Pusher with the fleet's push URL)
     deploys into a BERT fleet booted on production (replicas 2, versions
     2, the SLO monitor, CONT_PROBATION_S probation).  Tick 1 (spans 1-2):
     two span runs and a window run, version 2 through the canary and its
     captured buckets, GUARD_REQUESTS requests all 200, a healthy
     probation.  Tick 2: idle, no run, no launch.  Tick 3 (span 3): one
     span run, work saved 0.5, window [2, 3], version 3 deployed, then
     DEVICE_ERROR on every replica: rolled back to version 2 inside the
     probation with no capture, the rollback observed, its blessing
     un-blessed (markers rewritten), its model quarantined, latest blessed
     = version 2's model.  The window [2, 3]'s merged stats.json == a cold
     StatisticsGen's byte for byte.  A restarted controller reprocesses
     nothing; a pending marker resumes the window run (same run id, every
     node adopted, no deploy, no launch); a drift breach runs the window
     out of cadence, all cache hits but the resolver, a drift_evidence
     context recorded.  Every tick's launches are read inside the runner:
     12 x steps each backward kernel, 12 x (steps + the Trainer's eval
     batches + the Evaluator's passes x batches) forwards before the
     deploy, the deploy's own, 12 x device batches of the traffic; report
     each tick's wall time, nodes executed and cached, deploy_to_serving_s
     and breach-to-rollback seconds;
 15. dag_machinery — in the workdir the bert_dag phase left (its store,
     written by the Python backend, its artifacts and CSV), through
     ``python -m tpu_pipelines_torch`` in this process: ``lint`` on the
     taxi, BERT and T5 example pipelines exits 0 with no ERROR; a copy of
     ``examples/bert_module.py`` with ``.item()`` inside ``loss_fn`` gets
     TPP203 at ERROR on that line, and ``run --lint error`` refuses it
     (exit 3, no launch, no execution written); with
     ``TPP_METADATA_BACKEND=native`` and MACHINERY_STEPS steps, ``run
     --from-node Trainer``: ingest through Transform SKIPPED with
     bert_dag's artifact ids, the Trainer and the Evaluator executed on
     the card, the runner's store the native class loaded from
     ``_build/``, each backward kernel 12 x steps and the forward 12 x
     (steps + the Trainer's eval batches + the Evaluator's), read inside
     the runner, and ``inspect runs`` (the Python backend) lists the
     partial run; ``run --to-node Transform`` all cache hits, no launch;
     StatisticsGen over bert_dag's examples at MACHINERY_SHARDS shards on
     fresh pipeline roots: the fork pool's stats.json == the thread
     pool's byte for byte from child pids, a KILL_SHARD_WORKER run
     replaced (the death counted) with the same bytes, and a shard cut
     short quarantined under ``salvage_shards`` with the node COMPLETE;
 15a. serving_surface — the rest of the serving surface on the bert_dag
     phase's model (flash attention) and the engine_levers phase's T5:
     BERT-base behind two replicas with request tracing "all", REST and
     gRPC ``Predict`` on raw and (``raw=False``) on the Transform's
     examples, every reply within LOGIT_TOL of the payload's eager
     predict / predict_transformed, flash_fwd 12 x device batches (graph
     replays), exemplars on /metrics; T5 as the generative type with every
     engine lever on over REST ``:generate`` and gRPC ``Generate`` (equal,
     every served token the target's greedy choice within
     DECODE_LOGIT_TOL, a swapped token above it), ``GetModelStatus`` and
     ``Reload`` to a version 2, each version's flash_decode over its
     generates 6 x (prefill passes + target and draft step replays);
     ``python -m tpu_pipelines_torch trace serve`` reads every request's
     span chain back; the InfraValidator blesses over gRPC on the Transform's
     examples (``raw_examples=False``); the payload's ``torch.export``
     artifact on the card equals predict at two batch sizes, the forward
     launched 12 times a call; the BERT DAG rerun at SURFACE_STEPS steps with
     ``TPP_FEDERATION_DIR`` and ``TPP_METRICS_HISTORY``: the runner's
     ``TPP_METRICS_PORT``, scraped once inside the Trainer, merges the
     fleet's series, and ``trace`` fills the run's train_telemetry from
     the metrics-history ring once its own summary is cut from the log;
 15b. tune_rewrite — search, the trainer's extras and rewriting at BERT_BASE
     over TUNE_ROWS seeded reviews, one DAG through ``python -m
     tpu_pipelines_torch run`` in this process: CsvExampleGen ->
     StatisticsGen -> SchemaGen -> Transform -> Tuner (successive halving
     over TUNE_LRS, rungs TUNE_RUNGS, trials in-process) and TunerIsolated
     (one rung of one trial, TUNE_LRS[0] at TUNE_RUNGS[0] steps, with
     ``isolate_trials``: a ``tuner_trial`` child, its device in its spec)
     -> Trainer (the
     Tuner's best rate, TUNE_STEPS steps with ``profile_dir``,
     ``tensorboard_dir``, ``collect_cost_analysis`` and ``stall_timeout_s``
     through ``custom_config["train_loop"]``) -> Evaluator -> Rewriter
     (bfloat16 and aqt_int8, the accuracy gate on the eval slice) -> Pusher
     (``variant="aqt_int8"``): every node COMPLETE; the Trainer on the
     best rate; each in-process trial's device memory back within
     TUNE_MEM_MARGIN; MFU from the loop and counted FLOPs within
     TUNE_FLOP_TOL of the analytic figure; the profile names each flash
     kernel (profile_to - profile_from) x layers times; the event files
     (read by this script) hold the loss at every log step; goodput in
     (0, 1] from the tracker with its badput, the proxy beside it, no
     stall alert; the Rewriter's latency, resident bytes and deltas, the
     int8 variant at most INT8_BYTES_MAX of float32's bytes;
     TunerIsolated's child trial gives the metrics of the in-process trial
     of its rate and budget; the pushed int8 payload behind a fleet:
     bucket graphs captured before its first reply, replay == eager,
     logits within INT8_LOGIT_TOL of the float32 variant's (a mask-dropped
     control above it), an unblessed copy 409 with version 1 serving on;
     p50 of each variant behind a fleet of its own.  Launches: the DAG's
     read inside the runner, the child trial's from its result file (in
     trials.json), and each fleet's over its served requests alone (after
     one warm-up request, before any check's own computation), where the
     forward launched 12 x the device batches served and nothing else;
 16. vision_train — ResNet-50 at full width (depth 50, width 64, 1000
     classes, 224x224, batch 256, bf16, SGD-Nesterov 0.1/0.9: the ResNet
     twin's ``EXAMPLE_DEFAULTS``) through ``train_loop(has_model_state=True)``,
     ``--train-steps`` steps in windows of 4: one capture, a replay a step
     after the first, no compile after warm-up; the same run with cuDNN held
     to deterministic algorithms equals the steps written out eagerly bit for
     bit (losses, every parameter, momentum buffer and running mean and
     variance), the running statistics moved at every step (a ``bn_state``
     metric summed inside the captured step, and each buffer of the eager
     run); eval on the running averages against train-mode BatchNorm on the
     same rows (the control, far apart); report examples/s (default and
     deterministic cuDNN, eager), the idle share of a replayed step, the peak
     memory and an MFU from the conv and dense layer shapes, and the loop's
     own MFU (``collect_cost_analysis``), its counted FLOPs within
     TUNE_FLOP_TOL of the layer-shape figure;
 17. vision_serving — that model exported, served by ``ModelServer(
     replicas=1, max_versions=2, max_batch_size=8)``: its first request
     captures one graph per padded bucket before it is served; 8 requests of
     1-4 rows of 224*224*3 floats, every reply 200, within VISION_SERVE_TOL
     of the payload's eager predict of the same rows, no compile after
     warm-up; train-mode BatchNorm (batch statistics) misses by far;
 18. mnist_dag and 19. resnet_dag — the MNIST and ResNet twins
     (ImportExampleGen over the npz -> Trainer -> Evaluator, multiclass)
     through ``python -m tpu_pipelines_torch run --pipeline-module`` in this
     process: MNIST at its defaults (4,096 rows, 100 steps of 128); ResNet
     at depth 50 and 224x224 with the twin's 60 steps of 64 over its
     synthetic images cut to RESNET_DAG_ROWS rows; every node COMPLETE, one
     capture, no attention kernel; a warm rerun all cache hits with no
     allocation on the card; the payload's 2 x 53 running buffers moved off
     their init; the Evaluator's metrics.json keys the reference's; ``trace
     latest`` read back cold (0.0) and warm (1.0); report each node's wall
     and the ingest's rows/s.

After the last phase it prints the whole script's seconds.  The last
three lines are the ``kernels`` JSON record, the card's name and
power limit as ``nvidia-smi`` prints them, and ``{"ok": true, "device":
{...}}``.  Without CUDA the script exits 2 before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from tpu_pipelines_torch.examples import bert_module, resnet_module, t5_module
from tpu_pipelines_torch.models import t5 as t5m
from tpu_pipelines_torch.models import transformer as tfm
from tpu_pipelines_torch.models.bert import (
    DEFAULT_HPARAMS,
    build_bert_model,
    init_bert_weights,
)
from tpu_pipelines_torch.models.resnet import (
    Conv,
    build_resnet_model,
    init_resnet_weights,
)
from tpu_pipelines_torch.observability.drift import DEFAULT_DRIFT_THRESHOLD
from tpu_pipelines_torch.observability.metrics import default_registry
from tpu_pipelines_torch.ops import _build
from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.parallel.ring_attention import dense_attention
from tpu_pipelines_torch.serving.generative import GenerativeEngine
from tpu_pipelines_torch.serving.server import ModelServer
from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop
from tpu_pipelines_torch.trainer.export import export_model, load_exported_model
from tpu_pipelines_torch.trainer.train_loop import (
    TrainState,
    _peak_flops_per_chip,
    _step_seed,
    _TrainStep,
    step_generator,
)

REPO = os.path.dirname(os.path.abspath(__file__))
BERT_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples", "bert_module.py")
T5_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples", "t5_module.py")

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# operations/s by input type (bf16/fp16 on the tensor cores, f32 on the
# FMA units).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12,
}
# Kernel vs plain version: both compute in f32 and differ only in the order
# of f32 sums, so each output element may land one rounding step (ulp) of
# the output dtype away: |out - ref| <= atol + rtol * |ref| with rtol one
# ulp relative (bf16 2^-7, fp16 2^-10) and a small atol for outputs near 0.
# That holds for the decode kernel and the f32 forward.  The bf16/fp16
# forward also rounds p to the input dtype before O = p v, as SDPA and dense
# bf16 attention do, while the plain version keeps p in f32: per element
#   |out - ref| <= u * term + L * 2^-24 * max|ref| + rtol * |ref| + atol
# with term = sum_k (p_k / l) |v_k| (fa.fwd_rounding_terms) and u =
# fa.UNIT_ROUNDOFF (2^-8 bf16, 2^-11 fp16); L * 2^-24 * max|ref| covers the
# order of the L-term f32 sums (see F32_EPS).  The kernel fed the mask
# shifted by one key must land above that bound, on out and on lse.  The
# LSE is f32 in both (the tensor cores accumulate q.k in f32, and the
# kernel's exp2 is the SFU's, relative error ~2^-22).
OUT_TOL = {  # dtype: (rtol, atol)
    torch.bfloat16: (2.0 ** -7, 1e-5),
    torch.float16: (2.0 ** -10, 1e-6),
    torch.float32: (1e-6, 1e-6),
}
LSE_TOL = (1e-6, 1e-5)
# Served logits, flash vs dense attention, bf16 compute: both round the
# softmax probabilities to bf16 before P.V, dense after normalising and
# flash before (against each 32-key chunk's running max), so the two drift
# apart by bf16 rounding through 12 layers.  The serving phase also runs
# controls (the flash payload fed a wrong key mask) and fails unless each
# of them lands above this tolerance.  On an H100 80GB HBM3 (700 W) at
# --seed 0 the sound gap was 7.5e-3 (8.4e-3 with a forward that kept p in
# f32) and the controls 1.98e-1 and 1.91e-1: the tolerance sits near their
# geometric mean.
LOGIT_TOL = 4e-2
N_LAYERS = DEFAULT_HPARAMS["n_layers"]
SEQ_LEN = 128
# The BERT DAG's sequence length: its tokenizer's MAX_LEN.
PIPELINE_LEN = 64
# Backward kernels vs their plain versions, from the same q, k, v, dO, lse
# and Dvec.  Each gradient element may land one rounding step of the output
# dtype away (OUT_TOL's rtol), plus an absolute term for elements that
# cancel: two orders of a sum of L terms differ by at most about L * 2^-24
# of the sum of |terms|, taken as L * 2^-24 * max|ref| of the tensor.  The
# f32 kernels differ from the plain version only in that order.  The bf16
# and fp16 kernels also round p and dS to the input dtype before the second
# products (dV = p^T dO, dK = scale dS^T q, dq = scale dS k), as SDPA and
# dense bf16 attention do, while the plain version keeps them in f32: that
# moves each element by at most u = fa.UNIT_ROUNDOFF (2^-8 bf16, 2^-11
# fp16) times its sum of |terms| (fa.bwd_rounding_terms: |p|^T |dO|,
# scale |dS|^T |q|, scale |dS| |k|).  So per element
#   |got - ref| <= u * term + L * 2^-24 * max|ref| + rtol * |ref|,
# and a control (the kernels fed the mask shifted by one key) must land
# above that bound, or it could hide a fault.  Dvec: two orders of a sum of
# D f32 products differ by at most 2 * D * 2^-24 of the row's sum of
# |dO * O|.
F32_EPS = 2.0 ** -24
# The attention's gradients (forward and backward kernels through the
# autograd Function) vs autograd through dense attention, f32: two formulas
# (softmax vs the saved LSE), f32 sums over at most 100 keys.
DENSE_GRAD_TOL = (1e-5, 2e-5)  # (rtol, atol)
TRAIN_BATCH = 256
TRAIN_LR = 2e-5
TRAIN_WINDOW = 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device ms per call on the current stream, by CUDA events.

    The timed launches queue behind a device-side sleep sized to outlast
    their host enqueue time (twice the warm-up's enqueue time, in cycles of
    a 2 GHz clock, above the H100's top SM clock, so the sleep lasts at
    least that long), so the events bracket back-to-back device work: a
    wrapper whose Python costs more than its kernel does not inflate the
    kernel's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * iters * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ kernels

# name, batch, len, heads, head_dim, dtype, causal, mask, strided inputs;
# "serving" and "training" are the BERT-base paths' shapes, "pipeline" the
# BERT DAG's (its tokenizer's max_len), "hole" masks one whole interior
# 64-key block of every row.
KERNEL_CASES = [
    ("serving", 32, SEQ_LEN, 12, 64, torch.bfloat16, False, "ragged", False),
    ("training", TRAIN_BATCH, SEQ_LEN, 12, 64, torch.bfloat16, False, "ragged",
     False),
    ("pipeline", TRAIN_BATCH, PIPELINE_LEN, 12, 64, torch.bfloat16, False,
     "ragged", False),
    ("ragged_len", 2, 200, 4, 64, torch.bfloat16, False, "ragged", False),
    ("causal", 2, 200, 4, 32, torch.bfloat16, True, "ragged", False),
    ("empty_row", 4, SEQ_LEN, 2, 64, torch.bfloat16, False, "empty_row", False),
    ("fp16_d128_strided", 2, 130, 3, 128, torch.float16, False, "ragged", True),
    ("f32_d16", 3, 96, 2, 16, torch.float32, False, "ragged", False),
    ("no_mask_causal", 2, 77, 2, 64, torch.bfloat16, True, "none", False),
    ("hole", 2, 200, 4, 64, torch.bfloat16, False, "hole", False),
]


def tol_ratio(got, want, rtol_atol) -> float:
    """max |got - want| / (atol + rtol * |want|): at most 1 within tolerance."""
    rtol, atol = rtol_atol
    got, want = got.double(), want.double()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def kernel_inputs(gen, b, l, h, d, dtype, mask_kind, strided, n=3):
    """``n`` random [b, l, h, d] tensors (q, k, v and, for the backward,
    dO) and the key mask; strided: slices of one packed tensor."""
    dev = "cuda"
    if strided:  # slices of one packed [b, l, n, h, d] tensor
        packed = torch.randn(b, l, n, h, d, generator=gen).to(dev, dtype)
        tensors = [packed[:, :, i] for i in range(n)]
    else:
        tensors = [torch.randn(b, l, h, d, generator=gen).to(dev, dtype)
                   for _ in range(n)]
    if mask_kind == "none":
        return (*tensors, None)
    if mask_kind == "hole":  # keys 64..127 masked in every row, the rest allowed
        mask = torch.ones(b, l, dtype=torch.int32)
        mask[:, 64:128] = 0
        return (*tensors, mask.to(dev))
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    mask = (torch.arange(l)[None, :] < lengths[:, None]).to(torch.int32)
    if mask_kind == "empty_row":
        mask[1] = 0
    return (*tensors, mask.to(dev))


def fwd_ratio(out, ref, term, dtype, l):
    """max |out - ref| over the forward's bound for ``dtype`` (see
    OUT_TOL): at most 1 within tolerance."""
    if dtype == torch.float32:
        return tol_ratio(out, ref, OUT_TOL[dtype])
    return rounding_ratio(out, ref, term, dtype, l, atol=OUT_TOL[dtype][1])


def fwd_resources():
    """Print the forward kernel's registers, local memory and dynamic
    shared memory (at L = SEQ_LEN) for every dtype and head dim (f32: the
    FMA kernel; bf16, fp16: the tensor-core kernel); returns them for the
    main paths' instantiation (bf16, D = 64)."""
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        print(f"kernel flash_fwd resources {dtype}: " + "; ".join(
            "D={d} {registers} registers, {local_bytes} B local, "
            "{shared_bytes} B shared".format(
                d=d, **fa.fwd_kernel_info(dtype, d, SEQ_LEN))
            for d in fa.HEAD_DIMS), flush=True)
    return fa.fwd_kernel_info(torch.bfloat16, 64, SEQ_LEN)


def kernel_phase(gen):
    """Every forward case within its bound, its shifted-mask control above
    it on out and lse, repeats bit for bit, all-masked rows exact; returns
    the flash_fwd record (without launches) measured at the serving shape,
    with the training shape's times beside them."""
    resources = fwd_resources()
    max_out_err = max_lse_err = 0.0
    timings = {}
    for name, b, l, h, d, dtype, causal, mask_kind, strided in KERNEL_CASES:
        q, k, v, mask = kernel_inputs(gen, b, l, h, d, dtype, mask_kind, strided)
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
        again = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(
            q, k, v, causal=causal, kv_mask=mask
        )
        term = fa.fwd_rounding_terms(q, k, v, causal=causal, kv_mask=mask)
        out_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        out_ratio = fwd_ratio(out, ref_out, term, dtype, l)
        lse_ratio = tol_ratio(lse, ref_lse, LSE_TOL)
        repeat = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        ok = (
            torch.isfinite(out.float()).all().item()
            and out_ratio <= 1.0 and lse_ratio <= 1.0 and repeat
        )
        exact = ""
        if mask_kind == "empty_row":
            zero = (out[1].abs().max().item() == 0.0
                    and bool((lse.view(b, h, l)[1] == fa.NEG_INF).all().item()))
            exact = f"; all-masked row out exactly 0, lse exactly -1e30: {zero}"
            ok = ok and zero
        control = "n/a (no mask)"
        if mask is not None:
            wrong_out, wrong_lse = fa.flash_attention_forward(
                q, k, v, causal=causal, kv_mask=torch.roll(mask, 1, dims=1))
            controls = (fwd_ratio(wrong_out, ref_out, term, dtype, l),
                        tol_ratio(wrong_lse, ref_lse, LSE_TOL))
            control = f"out {controls[0]:.3g}, lse {controls[1]:.3g}"
            ok = ok and min(controls) > 1.0
        bound = ("the f32 tol" if dtype == torch.float32
                 else f"the bound (u {fa.UNIT_ROUNDOFF[dtype]:g})")
        print(f"kernel flash_fwd {name}: B={b} L={l} H={h} D={d} {dtype} "
              f"causal={causal} mask={mask_kind} strided={strided} "
              f"max|out-ref|={out_err:.3e} ({out_ratio:.3f} of {bound}) "
              f"max|lse-ref|={lse_err:.3e} ({lse_ratio:.3f} of tol "
              f"{LSE_TOL[1]:g} + {LSE_TOL[0]:g}*|ref|); shifted-mask control "
              f"{control} (each must exceed 1); repeat bit for bit: "
              f"{repeat}{exact}", flush=True)
        if not ok:
            raise AssertionError(f"flash_fwd {name}: kernel disagrees with "
                                 "its plain version, a control stays within "
                                 "the bound, or a repeat differs")
        max_out_err = max(max_out_err, out_err)
        max_lse_err = max(max_lse_err, lse_err)
        if name in ("serving", "training", "pipeline"):
            timings[name] = fwd_timing(name, q, k, v, mask, causal)
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tpu_pipelines_torch/csrc/flash_attention.cu",
        "replaces": "tpu_pipelines/ops/flash_attention.py:59",
        "tpu_kernel": "_fwd_kernel",
        **timings["serving"],
        **{f"{path}_{key}": timings[path][key]
           for path in ("training", "pipeline")
           for key in ("shape", "ms", "plain_ms", "bound_ms", "library_ms")},
        "max_abs_err": max_out_err,
        "lse_max_abs_err": max_lse_err,
        **resources,
    }


def fwd_timing(name, q, k, v, mask, causal):
    b, l, h, d = q.shape
    item = q.element_size()
    ms = time_ms(lambda: fa.flash_attention_forward(
        q, k, v, causal=causal, kv_mask=mask))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=causal, kv_mask=mask), iters=20, warmup=3)
    # Yardstick only: one PyTorch call computing the same function (no row
    # of these cases is fully masked, where SDPA and the kernel would
    # differ).
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    attn_mask = (mask > 0)[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=attn_mask))
    # Least time for the same work, counted over what this run's mask
    # needs: q read and out written in full, k and v read only at allowed
    # keys, the [B, L] int32 mask read and the [B*H, L] f32 LSE written
    # once; operations over the allowed (query, key) pairs.
    allowed_keys = int((mask > 0).sum().item())       # over batch rows
    bytes_moved = (2 * q.numel() * item + 2 * allowed_keys * h * d * item
                   + b * l * 4 + b * h * l * 4)
    ops = 4 * h * d * l * allowed_keys
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    print(f"kernel flash_fwd {name} shape: {ms:.4f} ms (plain {plain_ms:.4f} "
          f"ms, sdpa {library_ms:.4f} ms); bound {max(t_bytes, t_ops)*1e3:.4f} "
          f"ms ({bytes_moved} bytes, {ops} ops)", flush=True)
    return {
        "shape": f"B={b} L={l} H={h} D={d} {str(q.dtype).replace('torch.', '')}",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


# (name, batch, len, heads, head_dim, dtype, causal, mask, strided inputs)
# for the backward kernels; "training" is the fine-tune phase's shape,
# "pipeline" the BERT DAG's, "hole" masks one whole interior 64-key block
# of every row.
BWD_CASES = [
    ("training", TRAIN_BATCH, SEQ_LEN, 12, 64, torch.bfloat16, False, "ragged", False),
    ("pipeline", TRAIN_BATCH, PIPELINE_LEN, 12, 64, torch.bfloat16, False,
     "ragged", False),
    ("ragged_len", 2, 200, 4, 64, torch.bfloat16, False, "ragged", False),
    ("causal", 2, 200, 4, 32, torch.bfloat16, True, "ragged", False),
    ("empty_row", 4, SEQ_LEN, 2, 64, torch.bfloat16, False, "empty_row", False),
    ("fp16_d128_strided", 2, 130, 3, 128, torch.float16, False, "ragged", True),
    ("f32_d16", 3, 96, 2, 16, torch.float32, False, "ragged", False),
    ("no_mask_causal", 2, 77, 2, 64, torch.bfloat16, True, "none", False),
    ("hole", 2, 200, 4, 64, torch.bfloat16, False, "hole", False),
    ("bf16_d16_causal", 3, 96, 2, 16, torch.bfloat16, True, "ragged", False),
]


def rounding_ratio(got, want, term, dtype, l, atol=0.0):
    """max |got - want| over the per-element bound of a 16-bit kernel that
    rounds p (and dS) before its second products (see F32_EPS and
    OUT_TOL): at most 1 within tolerance."""
    want = want.double()
    bound = (fa.UNIT_ROUNDOFF[dtype] * term.double()
             + l * F32_EPS * want.abs().max() + OUT_TOL[dtype][0] * want.abs()
             + atol)
    err = (got.double() - want).abs()
    return torch.where(err == 0, 0.0, err / bound).max().item()


def bwd_resources():
    """Print each backward kernel's registers, local memory and dynamic
    shared memory (at L = SEQ_LEN) for every dtype and head dim; returns
    them for the training instantiation (bf16, D = 64)."""
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for d in fa.HEAD_DIMS:
            parts = []
            for kernel in ("dq", "dkv"):
                info = fa.bwd_kernel_info(kernel, dtype, d, SEQ_LEN)
                parts.append(f"{kernel} {info['registers']} registers, "
                             f"{info['local_bytes']} B local, "
                             f"{info['shared_bytes']} B shared")
            print(f"kernel flash_bwd resources {dtype} D={d}: "
                  + "; ".join(parts), flush=True)
    return {kernel: fa.bwd_kernel_info(kernel, torch.bfloat16, 64, SEQ_LEN)
            for kernel in ("dq", "dkv")}


def bwd_kernel_phase(gen):
    """Every backward case within tolerance, its shifted-mask control above
    it, repeats bit for bit, masked keys and rows exact zeros, Dvec within
    its bound, the gradients against dense attention; returns the
    flash_bwd_dq and flash_bwd_dkv records (without launches) measured at
    the training shape, with the BERT DAG's shape's times beside them."""
    resources = bwd_resources()
    max_err = {"dq": 0.0, "dkv": 0.0, "dvec": 0.0}
    timed = {}
    for name, b, l, h, d, dtype, causal, mask_kind, strided in BWD_CASES:
        q, k, v, dout, mask = kernel_inputs(gen, b, l, h, d, dtype, mask_kind,
                                            strided, n=4)
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
        dvec = fa.flash_bwd_dvec(out, dout)
        args = (q, k, v, dout, lse, dvec)

        def kernels(kv_mask):
            return (fa.flash_bwd_dq(*args, causal=causal, kv_mask=kv_mask),
                    *fa.flash_bwd_dkv(*args, causal=causal, kv_mask=kv_mask))

        grads = kernels(mask)
        again = kernels(mask)
        torch.cuda.synchronize()
        ref_dvec = fa._dvec(out, dout)
        dvec_bound = 2 * d * F32_EPS * (dout.float() * out.float()).abs().sum(-1)
        dvec_bound = dvec_bound.permute(0, 2, 1).reshape(b * h, l)
        dvec_err = (dvec - ref_dvec).abs()
        dvec_ratio = torch.where(dvec_err == 0, 0.0,
                                 dvec_err / dvec_bound).max().item()
        max_err["dvec"] = max(max_err["dvec"], dvec_err.max().item())
        refs = (fa.flash_bwd_dq_reference(*args, causal=causal, kv_mask=mask),
                *fa.flash_bwd_dkv_reference(*args, causal=causal, kv_mask=mask))
        terms = fa.bwd_rounding_terms(*args, causal=causal, kv_mask=mask)
        ratios = [rounding_ratio(got, want, term, dtype, l)
                  for got, want, term in zip(grads, refs, terms)]
        ok = (all(torch.isfinite(g.float()).all().item() for g in grads)
              and max(ratios) <= 1.0 and dvec_ratio <= 1.0)
        repeat = all(torch.equal(g, r) for g, r in zip(grads, again))
        zeros = ""
        if mask_kind == "empty_row":  # the all-masked batch row
            zero = all(g[1].abs().max().item() == 0.0 for g in grads)
            zeros = f"; all-masked row exactly 0: {zero}"
            ok = ok and zero
        if mask_kind == "hole":  # the masked block's keys get nothing
            zero = all(g[:, 64:128].abs().max().item() == 0.0 for g in grads[1:])
            zeros = f"; masked key block's dk, dv exactly 0: {zero}"
            ok = ok and zero
        controls = []
        if mask is not None:
            shifted = kernels(torch.roll(mask, 1, dims=1))
            controls = [rounding_ratio(got, want, term, dtype, l)
                        for got, want, term in zip(shifted, refs, terms)]
            ok = ok and min(controls) > 1.0
        for kernel, got, want in zip(("dq", "dkv", "dkv"), grads, refs):
            max_err[kernel] = max(max_err[kernel], (got.double() - want.double())
                                  .abs().max().item())
        print(f"kernel flash_bwd {name}: B={b} L={l} H={h} D={d} {dtype} "
              f"causal={causal} mask={mask_kind} strided={strided}: "
              + ", ".join(f"{g} {r:.3f}" for g, r in zip(("dq", "dk", "dv"), ratios))
              + f" of the bound (u {fa.UNIT_ROUNDOFF[dtype]:g}); Dvec "
              f"{dvec_ratio:.3f} of its bound; shifted-mask control "
              + (", ".join(f"{g} {r:.3g}" for g, r in zip(("dq", "dk", "dv"), controls))
                 or "n/a (no mask)")
              + f" (each must exceed 1); repeat bit for bit: {repeat}{zeros}",
              flush=True)
        if not (ok and repeat):
            raise AssertionError(f"flash_bwd {name}: kernels disagree with "
                                 "their plain versions, a control stays "
                                 "within the bound, or a repeat differs")
        if name in ("training", "pipeline"):
            timed[name] = bwd_timing(name, q, k, v, dout, out, lse, dvec, mask)
    records = timed["training"]
    for record, pipeline in zip(records, timed["pipeline"]):
        record.update({f"pipeline_{key}": value for key, value in
                       pipeline.items() if key in ("shape", "ms", "plain_ms",
                                                   "bound_ms", "library_ms",
                                                   "dvec_ms", "dvec_plain_ms",
                                                   "dvec_bound_ms",
                                                   "backward_ms")})
    for kernel, record in zip(("dq", "dkv"), records):
        record["max_abs_err"] = max_err[kernel]
        record.update(resources[kernel])
    records[0]["dvec_max_abs_err"] = max_err["dvec"]
    dense_gradient_check(gen)
    return records


def dense_gradient_check(gen):
    """Gradients through the autograd Function (forward and backward
    kernels) against autograd through dense attention, f32 (an independent
    oracle: softmax in place of the saved LSE)."""
    for causal in (False, True):
        # Ragged lengths >= 1: no empty row, where dense attention differs.
        q, k, v, dout, mask = kernel_inputs(gen, 2, 100, 3, 32, torch.float32,
                                            "ragged", False, n=4)
        grads = []
        for attend in (fa.flash_attention, dense_attention):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            attend(*leaves, causal=causal, kv_mask=mask).backward(dout)
            grads.append([t.grad for t in leaves])
        ratio = max(tol_ratio(a, b, DENSE_GRAD_TOL) for a, b in zip(*grads))
        err = max((a - b).abs().max().item() for a, b in zip(*grads))
        print(f"kernel flash_bwd gradients vs autograd through dense attention "
              f"(f32, causal={causal}): max|err|={err:.3e} ({ratio:.3f} of tol "
              f"{DENSE_GRAD_TOL[1]:g} + {DENSE_GRAD_TOL[0]:g}*|ref|)", flush=True)
        if ratio > 1.0:
            raise AssertionError("flash attention gradients disagree with "
                                 "dense attention")


def bwd_timing(label, q, k, v, dout, out, lse, dvec, mask):
    b, l, h, d = q.shape
    item = q.element_size()
    args = (q, k, v, dout, lse, dvec)
    ms = {
        "dq": time_ms(lambda: fa.flash_bwd_dq(*args, kv_mask=mask)),
        "dkv": time_ms(lambda: fa.flash_bwd_dkv(*args, kv_mask=mask)),
    }
    plain_ms = {
        "dq": time_ms(lambda: fa.flash_bwd_dq_reference(*args, kv_mask=mask),
                      iters=10, warmup=2),
        "dkv": time_ms(lambda: fa.flash_bwd_dkv_reference(*args, kv_mask=mask),
                       iters=10, warmup=2),
    }
    dvec_ms = time_ms(lambda: fa.flash_bwd_dvec(out, dout))
    dvec_plain_ms = time_ms(lambda: fa._dvec(out, dout), iters=50)
    total_ms = time_ms(lambda: fa.flash_attention_backward(
        q, k, v, out, lse, dout, kv_mask=mask))
    # Yardstick only: SDPA's backward (dq, dk and dv in one call), timed
    # alone at the same shape and mask (no row of this case is empty).
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=(mask > 0)[:, None, None, :])
    dout_t = dout.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), dout_t, retain_graph=True), iters=50)
    # Least time for the same work, counted over what this run's mask
    # needs: q, dO, lse and Dvec rows of batch rows with any allowed key
    # (an empty row's gradients are zeros to write), k and v only at allowed
    # keys, the [B, L] int32 mask; each gradient written once.  Operations
    # over the allowed (query, key) pairs: s, dP and dQ (dq kernel) or s,
    # dP, dV and dK (dkv kernel), 2*D each.
    allowed_keys = (mask > 0).sum(dim=1)                     # per batch row
    live_rows = int((allowed_keys > 0).sum().item())
    pairs = h * l * int(allowed_keys.sum().item())
    full = b * l * h * d * item
    rows_in = 2 * live_rows * l * h * d * item + 2 * live_rows * h * l * 4
    kv_in = 2 * int(allowed_keys.sum().item()) * h * d * item
    mask_in = b * l * 4
    work = {
        "dq": (rows_in + kv_in + mask_in + full, 6 * d * pairs),
        "dkv": (rows_in + kv_in + mask_in + 2 * full, 8 * d * pairs),
    }
    replaces = {"dq": ("_dq_kernel", "tpu_pipelines/ops/flash_attention.py:154"),
                "dkv": ("_dkv_kernel", "tpu_pipelines/ops/flash_attention.py:193")}
    records = []
    for kernel in ("dq", "dkv"):
        bytes_moved, ops = work[kernel]
        t_bytes = bytes_moved / HBM_BYTES_PER_S
        t_ops = ops / PEAK_OPS_PER_S[q.dtype]
        print(f"kernel flash_bwd_{kernel} {label} shape: {ms[kernel]:.4f} ms "
              f"(plain {plain_ms[kernel]:.4f} ms); bound "
              f"{max(t_bytes, t_ops) * 1e3:.4f} ms ({bytes_moved} bytes, {ops} "
              f"ops)", flush=True)
        records.append({
            "name": f"flash_bwd_{kernel}",
            "route": "cuda",
            "source": "tpu_pipelines_torch/csrc/flash_attention_bwd.cu",
            "replaces": replaces[kernel][1],
            "tpu_kernel": replaces[kernel][0],
            "shape": f"B={b} L={l} H={h} D={d} {str(q.dtype).replace('torch.', '')}",
            "ms": ms[kernel],
            "plain_ms": plain_ms[kernel],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention backward (dq, dk, dv together)",
        })
    # Dvec: O and dO read once, the f32 [B*H, L] written once; 2 f32
    # operations per element on the FMA units.
    dvec_bytes = 2 * b * l * h * d * item + b * h * l * 4
    dvec_bound_ms = max(dvec_bytes / HBM_BYTES_PER_S,
                        2 * b * l * h * d / PEAK_OPS_PER_S[torch.float32]) * 1e3
    records[0].update({"dvec_ms": dvec_ms, "dvec_plain_ms": dvec_plain_ms,
                       "dvec_bound_ms": dvec_bound_ms,
                       "backward_ms": total_ms})
    print(f"kernel flash_bwd_dvec {label} shape: {dvec_ms:.4f} ms (plain "
          f"{dvec_plain_ms:.4f} ms); bound {dvec_bound_ms:.4f} ms "
          f"({dvec_bytes} bytes)", flush=True)
    print(f"kernel flash backward {label} shape: Dvec {dvec_ms:.4f} ms + dq "
          f"{ms['dq']:.4f} ms + dkv {ms['dkv']:.4f} ms = "
          f"{dvec_ms + ms['dq'] + ms['dkv']:.4f} ms; whole backward "
          f"(flash_attention_backward) {total_ms:.4f} ms; sdpa backward "
          f"{library_ms:.4f} ms", flush=True)
    return records


# (name, batch, cache len, heads, head_dim, dtype, validity, bias, arena,
# mask) for the decode kernel.  "served" is the beam-served step (4 rows x 4
# beams, every row at one position, T5's broadcast bias, the expanded bool
# mask of a scalar position), "engine" an engine bucket (a [:b, :kv] slice
# of an arena, ragged positions, per-row bias, a bool mask), "long_cache"
# the shape whose bound is the k/v bytes alone, "long_cache_b4" a one-row
# beam request at that cache, "engine_long" the long-cache engine run's
# 2048 bucket, "bulk_infer" the T5 DAG's BulkInferrer beam step (64 rows x
# 4 beams at its max_decode_len).  Validity: "pos" keys <= L/2 in every
# row, "ragged" keys <= a random position per row, "ragged_1500" the same
# with positions < 1500, "eighth" positions < L/8 (every split past the
# first holds no allowed key), "hole" ragged with keys 300..699 masked, "empty_row" ragged with
# row 1 all masked, "full" every key.  Mask: "int32", "bool", or
# "bool_expanded" (one bool row expanded over the batch, batch stride 0;
# needs "pos" or "full" validity).  The kernel takes S =
# fa.decode_splits(B, H, L, SMs) CTAs per (batch, head): the split_* cases
# cover uneven spans with L not a multiple of 64, masked splits, an empty
# row across splits, clusters of 3 and 7, f32 and D=128 (on an H100 SXM's
# 132 SMs "long_cache" runs 2, "engine_long" 5, "long_cache_b4" 8);
# "chunks" (S = 1, L = 4500) walks
# three 2048-key mask chunks; the cases with L <= 256 (4 blocks) run S = 1
# without a cluster.
DECODE_CASES = [
    ("served", 16, 128, 8, 64, torch.bfloat16, "pos", "broadcast", False,
     "bool_expanded"),
    ("engine", 8, 64, 8, 64, torch.bfloat16, "ragged", "per_row", True, "bool"),
    ("len_1", 4, 1, 8, 64, torch.bfloat16, "pos", "broadcast", False, "int32"),
    ("len_100", 4, 100, 8, 64, torch.bfloat16, "ragged", "per_row", False,
     "int32"),
    ("empty_row", 4, 128, 8, 64, torch.bfloat16, "empty_row", "per_row", False,
     "int32"),
    ("no_bias", 4, 128, 8, 64, torch.bfloat16, "ragged", "none", False, "int32"),
    ("fp16", 4, 100, 8, 64, torch.float16, "ragged", "per_row", True, "int32"),
    ("f32", 4, 100, 8, 64, torch.float32, "ragged", "broadcast", False, "int32"),
    ("d16", 4, 100, 8, 16, torch.bfloat16, "ragged", "per_row", False, "int32"),
    ("d32", 4, 100, 8, 32, torch.bfloat16, "ragged", "broadcast", False, "bool"),
    ("d128", 4, 100, 8, 128, torch.bfloat16, "ragged", "per_row", True, "int32"),
    ("split_ragged_len", 4, 1100, 8, 64, torch.bfloat16, "ragged", "per_row",
     False, "int32"),
    ("split_masked", 4, 2048, 8, 64, torch.bfloat16, "eighth", "broadcast",
     False, "bool"),
    ("split_empty_row", 4, 2048, 8, 64, torch.bfloat16, "empty_row", "per_row",
     False, "int32"),
    ("split_hole", 4, 1100, 8, 64, torch.bfloat16, "hole", "per_row", True,
     "bool"),
    ("split_bool_expanded", 4, 1000, 8, 64, torch.bfloat16, "pos", "broadcast",
     False, "bool_expanded"),
    ("split_f32", 4, 1100, 8, 64, torch.float32, "ragged", "per_row", True,
     "int32"),
    ("split_d128", 4, 2048, 8, 128, torch.bfloat16, "ragged", "per_row", True,
     "bool"),
    ("split_s3", 11, 1000, 8, 64, torch.bfloat16, "ragged", "broadcast", False,
     "int32"),
    ("split_s7", 5, 1000, 8, 64, torch.float16, "ragged", "per_row", False,
     "bool"),
    ("chunks", 34, 4500, 8, 64, torch.bfloat16, "ragged", "per_row", False,
     "int32"),
    ("long_cache", 32, 4096, 8, 64, torch.bfloat16, "full", "broadcast", False,
     "int32"),
    ("long_cache_b4", 4, 4096, 8, 64, torch.bfloat16, "full", "broadcast",
     False, "bool_expanded"),
    ("engine_long", 8, 2048, 8, 64, torch.bfloat16, "ragged_1500", "per_row",
     True, "bool"),
    ("bulk_infer", 4 * 64, 32, 8, 64, torch.bfloat16, "pos", "broadcast", False,
     "bool_expanded"),
    # A tensor-parallel T5-small rank's greedy step (A6c): 4 of the 8
    # heads, a 2048-key cache half full, the rank's bias rows [1, 4, 1, L].
    ("tp_rank", 8, 2048, 4, 64, torch.bfloat16, "pos", "broadcast", False,
     "bool_expanded"),
]
DECODE_TIMED = ("served", "long_cache", "long_cache_b4", "engine_long",
                "bulk_infer", "tp_rank")


def decode_inputs(gen, b, l, h, d, dtype, validity, bias_kind, arena, mask_kind):
    dev = "cuda"
    q = torch.randn(b, 1, h, d, generator=gen).to(dev, dtype)
    if arena:  # [:b, :l] slices of a larger [B, L, 2, H, D] cache
        cache = torch.randn(b + 2, l + 32, 2, h, d, generator=gen).to(dev, dtype)
        k, v = cache[:b, :l, 0], cache[:b, :l, 1]
    else:
        k, v = (torch.randn(b, l, h, d, generator=gen).to(dev, dtype)
                for _ in range(2))
    if validity == "full":
        pos = torch.full((b,), l - 1)
    elif validity == "pos":
        pos = torch.full((b,), l // 2)
    elif validity == "eighth":
        pos = torch.randint(0, l // 8, (b,), generator=gen)
    elif validity == "ragged_1500":
        pos = torch.randint(0, 1500, (b,), generator=gen)
    else:
        pos = torch.randint(0, l, (b,), generator=gen)
    mask = torch.arange(l)[None, :] <= pos[:, None]
    if validity == "empty_row":
        mask[1] = False
    if validity == "hole":
        mask[:, 300:700] = False
    bias = None
    if bias_kind != "none":
        rows = 1 if bias_kind == "broadcast" else b
        bias = torch.randn(rows, h, 1, l, generator=gen).to(dev)
    if mask_kind == "bool_expanded":
        assert validity in ("pos", "full")   # every row the same
        return q, k, v, mask[:1].to(dev).expand(b, l), bias
    return q, k, v, mask.to(dev, torch.int32 if mask_kind == "int32"
                            else torch.bool), bias


def decode_resources(shapes):
    """The decode kernel's registers, spills, shared memory and CTAs per SM
    per instantiation, and at each timed shape its splits S (the cluster
    size) and how many such clusters the card runs at once."""
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        cells = []
        for d in fa.HEAD_DIMS:
            info = fa.decode_kernel_info(dtype, d, 1)
            cells.append(f"D={d} {info['registers']} regs / "
                         f"{info['local_bytes']} B spill / "
                         f"{info['shared_bytes']} B smem / "
                         f"{info['ctas_per_sm']} CTAs per SM")
        print(f"kernel flash_decode resources {str(dtype).replace('torch.', '')}: "
              + "; ".join(cells), flush=True)
    out = {}
    for name, (b, l, h, d, dtype) in shapes.items():
        splits = fa.decode_splits(b, h, l, fa.sm_count("cuda"))
        info = fa.decode_kernel_info(dtype, d, splits)
        print(f"kernel flash_decode resources {name} (B={b} L={l} H={h} D={d}): "
              f"S={splits}, cluster size {splits}, {splits * b * h} CTAs, "
              f"{info['registers']} registers, {info['local_bytes']} B spill, "
              f"{info['shared_bytes']} B shared memory, at most "
              f"{info['max_active_clusters']} clusters at once", flush=True)
        out[name] = {"splits": splits, "registers": info["registers"],
                     "spill_bytes": info["local_bytes"],
                     "shared_bytes": info["shared_bytes"],
                     "max_active_clusters": info["max_active_clusters"]}
    return out


def decode_kernel_phase(gen):
    """Every decode case within one output ulp of the plain version and
    repeated bit for bit; returns the flash_decode record (without
    launches), timed at the DECODE_TIMED shapes."""
    max_err = 0.0
    timings = {}
    for (name, b, l, h, d, dtype, validity, bias_kind, arena,
         mask_kind) in DECODE_CASES:
        q, k, v, mask, bias = decode_inputs(gen, b, l, h, d, dtype, validity,
                                            bias_kind, arena, mask_kind)
        out = fa.flash_decode_attention(q, k, v, kv_mask=mask, bias=bias)
        again = fa.flash_decode_attention(q, k, v, kv_mask=mask, bias=bias)
        torch.cuda.synchronize()
        ref = fa.flash_decode_attention_reference(q, k, v, kv_mask=mask,
                                                  bias=bias)
        err = (out.float() - ref.float()).abs().max().item()
        ratio = tol_ratio(out, ref, OUT_TOL[dtype])
        ok = torch.isfinite(out.float()).all().item() and ratio <= 1.0
        repeats = torch.equal(out, again)
        if validity == "empty_row":
            ok = ok and out[1].abs().max().item() == 0.0
        print(f"kernel flash_decode {name}: B={b} L={l} H={h} D={d} {dtype} "
              f"S={fa.decode_splits(b, h, l, fa.sm_count('cuda'))} "
              f"validity={validity} "
              f"bias={bias_kind} arena={arena} mask={mask_kind} "
              f"max|out-ref|={err:.3e} ({ratio:.3f} of tol "
              f"{OUT_TOL[dtype][1]:g} + {OUT_TOL[dtype][0]:g}*|ref|); repeat "
              f"bit for bit {repeats}", flush=True)
        if not ok or not repeats:
            raise AssertionError(f"flash_decode {name}: kernel disagrees with "
                                 "its plain version or with itself")
        max_err = max(max_err, err)
        if name in DECODE_TIMED:
            timings[name] = decode_timing(name, q, k, v, mask, bias)
    resources = decode_resources({
        name: (b, l, h, d, dtype) for (name, b, l, h, d, dtype, *_)
        in DECODE_CASES if name in DECODE_TIMED})
    for name, res in resources.items():
        timings[name].update(res)
    return {
        "name": "flash_decode",
        "route": "cuda",
        "source": "tpu_pipelines_torch/csrc/flash_decode.cu",
        "replaces": "tpu_pipelines/ops/flash_attention.py:325",
        "tpu_kernel": "_decode_kernel",
        **timings["served"],
        **{name: timings[name] for name in DECODE_TIMED if name != "served"},
        "max_abs_err": max_err,
    }


def decode_timing(name, q, k, v, mask, bias):
    b, l, h, d = k.shape
    item = q.element_size()
    iters = 200 if l <= 1024 else 50
    # Yardstick only: SDPA with the bias and the validity folded into one
    # float mask, built outside the timed region (no row here is empty).
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    float_mask = torch.where((mask > 0)[:, None, None, :],
                             bias.expand(b, h, 1, l), float("-inf"))
    # Kernel and SDPA in turns, twice, each keeping its faster run: the
    # card idles while the inputs are made on the host, and the first
    # timing after an idle gap runs at lower clocks.
    runs = {"kernel": [], "sdpa": []}
    for _ in range(2):
        runs["kernel"].append(time_ms(lambda: fa.flash_decode_attention(
            q, k, v, kv_mask=mask, bias=bias), iters=iters))
        runs["sdpa"].append(time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=float_mask), iters=iters))
    ms, library_ms = min(runs["kernel"]), min(runs["sdpa"])
    plain_ms = time_ms(lambda: fa.flash_decode_attention_reference(
        q, k, v, kv_mask=mask, bias=bias), iters=20, warmup=3)
    # Least time for the same work: q read and out written once, k and v
    # read at the allowed keys only, the [B, L] mask (at its own element
    # size, once: an expanded mask is one row), the f32 bias at the allowed
    # keys only (a broadcast bias once for each key that any row allows);
    # about 4*D operations per (head, allowed key).
    allowed_keys = mask > 0
    allowed = int(allowed_keys.sum().item())
    mask_bytes = (mask.numel() if mask.stride(0) else l) * mask.element_size()
    bias_keys = (int(allowed_keys.any(dim=0).sum().item())
                 if bias.shape[0] == 1 else allowed)
    bytes_moved = (2 * q.numel() * item + 2 * allowed * h * d * item
                   + mask_bytes + bias_keys * h * 4)
    ops = 4 * d * h * allowed
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"kernel flash_decode {name} shape [{card_line()}]: {ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; in turns "
          f"kernel {runs['kernel'][0]:.4f} / {runs['kernel'][1]:.4f}, sdpa "
          f"{runs['sdpa'][0]:.4f} / {runs['sdpa'][1]:.4f}); bound "
          f"{bound_ms:.4f} ms ({bytes_moved} bytes, {ops} ops)", flush=True)
    return {
        "shape": f"B={b} L={l} H={h} D={d} {str(q.dtype).replace('torch.', '')}",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "library": "scaled_dot_product_attention with a float mask",
    }


# --------------------------------------------------------------- crossovers

# The lengths the crossover phase times: the reference's flash_probe and
# t5_decode lengths plus the port's own paths (the BERT DAG's 64 and the
# serving and training 128; the T5 DAG's beam step at 32 keys, the served
# step at 128).
CROSS_TRAIN_LENS = (64, 128, 512, 2048, 8192)
CROSS_TRAIN_GEOMETRY = {"batch": 8, "heads": 12, "head_dim": 64,
                        "dtype": "bfloat16"}
CROSS_DECODE_LENS = (32, 128, 512, 2048, 8192)
CROSS_DECODE_GEOMETRY = {"batch": 32, "heads": 8, "head_dim": 64,
                         "dtype": "bfloat16"}


def crossover_phase(gen, card):
    """Measure both crossovers "auto" attention reads and record them for
    this card (in the cache ``TPP_AUTOTUNE_CACHE`` names).  Training
    regime: the gradient of sum(attention(q, k, v)) through
    ``FlashAttentionFunction`` against the port's ``dense_attention``
    (B=8, H=12, D=64, bf16, no mask) at CROSS_TRAIN_LENS; where dense does
    not fit, flash is the only implementation that runs.  Decode regime:
    ``flash_decode_attention`` against dense cache attention (B=32, H=8,
    D=64, bf16, every key valid) at CROSS_DECODE_LENS.  Each crossover is
    the first length at which flash takes no longer than dense.  Returns
    the table rows recorded."""
    from tpu_pipelines_torch.ops import autotune

    dev = torch.device("cuda")
    kind = autotune.current_device_kind(dev)
    g = CROSS_TRAIN_GEOMETRY
    b, h, d = g["batch"], g["heads"], g["head_dim"]
    per_len, crossover = {}, None
    for l in CROSS_TRAIN_LENS:
        q, k, v = (torch.randn(b, l, h, d, generator=gen).to(dev, torch.bfloat16)
                   .requires_grad_() for _ in range(3))

        def grad_of(attn):
            return lambda: torch.autograd.grad(
                attn(q, k, v).float().sum(), (q, k, v))

        iters = 50 if l <= 2048 else 10
        flash_ms = time_ms(grad_of(lambda q, k, v: fa.FlashAttentionFunction
                                   .apply(q, k, v, None, False)),
                           iters=iters, warmup=3)
        fits = tfm.dense_attn_fits(b, h, l, l, 2, dev)
        dense_ms = (time_ms(grad_of(dense_attention), iters=iters, warmup=3)
                    if fits else None)
        per_len[str(l)] = {"flash_ms": flash_ms, "dense_ms": dense_ms}
        if crossover is None and (dense_ms is None or flash_ms <= dense_ms):
            crossover = l
        del q, k, v
    train_geometry = {**g, "per_len": per_len, "card": card}
    autotune.record_crossover(kind, crossover, geometry=train_geometry,
                              source="chip_smoke.py crossover phase")

    g = CROSS_DECODE_GEOMETRY
    b, h, d = g["batch"], g["heads"], g["head_dim"]
    per_kv, decode_crossover = {}, None
    for l in CROSS_DECODE_LENS:
        q = torch.randn(b, 1, h, d, generator=gen).to(dev, torch.bfloat16)
        k, v = (torch.randn(b, l, h, d, generator=gen).to(dev, torch.bfloat16)
                for _ in range(2))
        valid = torch.ones(b, l, dtype=torch.bool, device=dev)
        flash_ms = time_ms(lambda: fa.flash_decode_attention(q, k, v,
                                                             kv_mask=valid))
        dense_ms = time_ms(lambda: dense_attention(q, k, v, kv_mask=valid))
        per_kv[str(l)] = {"flash_ms": flash_ms, "dense_ms": dense_ms}
        if decode_crossover is None and flash_ms <= dense_ms:
            decode_crossover = l
    decode_geometry = {**g, "per_kv_len": per_kv, "card": card}
    autotune.record_decode_crossover(kind, decode_crossover,
                                     geometry=decode_geometry,
                                     source="chip_smoke.py crossover phase")
    autotune.clear_memo()
    if (autotune.lookup_crossover(kind), autotune.lookup_decode_crossover(
            kind)) != (crossover, decode_crossover):
        raise AssertionError("crossover: the recorded table does not read "
                             "back")
    for regime, rows, got in (("training", per_len, crossover),
                              ("decode", per_kv, decode_crossover)):
        print(f"crossover {regime} [{card}] {kind}: " + "; ".join(
            f"L={l} flash {r['flash_ms']:.4f} ms, dense "
            + (f"{r['dense_ms']:.4f} ms" if r["dense_ms"] is not None
               else "does not fit")
            for l, r in rows.items()) + f" -> crossover {got}", flush=True)
    return {"crossover": {kind: {"crossover_seq_len": crossover,
                                 "geometry": train_geometry,
                                 "source": "chip_smoke.py crossover phase"}},
            "decode_crossover": {kind: {
                "crossover_kv_len": decode_crossover,
                "geometry": decode_geometry,
                "source": "chip_smoke.py crossover phase"}}}




# ------------------------------------------------------------------ serving

def make_requests(rng, n_requests, vocab):
    requests = []
    for _ in range(n_requests):
        rows = []
        for _ in range(int(rng.integers(1, 3))):
            n = int(rng.integers(8, SEQ_LEN + 1))
            ids = np.zeros(SEQ_LEN, np.int64)
            ids[:n] = rng.integers(1, vocab, size=n)
            rows.append({"input_ids": ids.tolist(),
                         "attention_mask": (ids > 0).astype(np.int64).tolist()})
        requests.append({"instances": rows})
    return requests


# Clients run in their own interpreters (no torch), so that their JSON and
# HTTP work does not compete with the server for its interpreter lock.
CLIENT = r"""
import json, sys, time, urllib.error, urllib.request
from concurrent.futures import ThreadPoolExecutor
job = json.load(sys.stdin)

def post(item):
    i, payload = item
    req = urllib.request.Request(
        job["url"], data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            code, reply = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        code, reply = e.code, None
    return [i, code, reply, time.perf_counter() - t0]

t0 = time.perf_counter()
with ThreadPoolExecutor(job["threads"]) as pool:
    results = list(pool.map(post, job["requests"]))
json.dump({"t0": t0, "t1": time.perf_counter(), "results": results}, sys.stdout)
"""
N_CLIENT_PROCS = 4
CLIENT_THREADS = 16


def run_clients(url, requests, n_procs=N_CLIENT_PROCS, threads=CLIENT_THREADS):
    """POST every request from ``n_procs`` processes of ``threads`` threads
    each; returns ([(code, reply, seconds)] in request order, wall seconds
    from the first request sent to the last reply)."""
    procs = []
    try:
        for c in range(n_procs):
            proc = subprocess.Popen(
                [sys.executable, "-c", CLIENT], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True,
            )
            procs.append(proc)
            job = {"url": url, "threads": threads, "requests": [
                [i, requests[i]]
                for i in range(c, len(requests), n_procs)]}
            proc.stdin.write(json.dumps(job))
            proc.stdin.close()
        outs = []
        for proc in procs:
            outs.append(json.loads(proc.stdout.read()))
            if proc.wait(timeout=600) != 0:
                raise RuntimeError(f"client exited {proc.returncode}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = [None] * len(requests)
    for out in outs:
        for i, code, reply, seconds in out["results"]:
            results[i] = (code, reply, seconds)
    wall_s = max(o["t1"] for o in outs) - min(o["t0"] for o in outs)
    return results, wall_s


def step_breakdown(loaded, batch, iters=20):
    """Host wall time of one served forward step (predict on a padded
    batch, synchronized by its host copy) and, from torch.profiler, the
    device time its kernels take: (wall_ms, busy_ms, flash_ms, kernels)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        loaded.predict(batch)
    t0 = time.perf_counter()
    for _ in range(iters):
        loaded.predict(batch)
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            loaded.predict(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    flash_us = sum(e.time_range.elapsed_us() for e in kernels
                   if re.search(r"\bflash_fwd(_mma)?_kernel\b", e.name))
    return wall_ms, busy_us / 5e3, flash_us / 5e3, len(kernels) / 5


def serving_phase(seed, n_requests, card, workdir):
    hp = {**DEFAULT_HPARAMS, "attn_impl": "flash"}
    model = build_bert_model(hp)
    init_bert_weights(model, torch.Generator().manual_seed(seed))
    state = model.state_dict()
    base = os.path.join(workdir, "bert")
    export_model(serving_model_dir=os.path.join(base, "1"), params=state,
                 module_file=BERT_MODULE, hyperparameters=hp)
    dense_dir = os.path.join(workdir, "bert_dense", "1")
    export_model(serving_model_dir=dense_dir, params=state,
                 module_file=BERT_MODULE,
                 hyperparameters={**hp, "attn_impl": "dense"})
    del model, state

    rng = np.random.default_rng(seed)
    requests = make_requests(rng, n_requests, hp["vocab_size"])
    torch.cuda.reset_peak_memory_stats()
    server = ModelServer("bert", base, batching=True, max_batch_size=32,
                         device="cuda")
    try:
        port = server.start(port=0)
        url = f"http://127.0.0.1:{port}/v1/models/bert:predict"
        warm, _ = run_clients(url, requests[:1])  # first cuBLAS calls
        if warm[0][0] != 200:
            raise AssertionError(f"warm-up request answered {warm[0][0]}")
        batches = server.metrics.get("serving_batches_total")
        batches_before = batches.get()
        fa.launches = 0
        results, wall_s = run_clients(url, requests)
        launches = fa.launches
        n_batches = int(batches.get() - batches_before)
        peak_bytes = torch.cuda.max_memory_allocated()
        scrape = server.metrics.to_prometheus()
    finally:
        server.stop()

    codes = [c for c, _, _ in results]
    if any(c != 200 for c in codes):
        raise AssertionError(f"non-200 replies: {sorted(set(codes))}")
    for payload, (_, reply, _) in zip(requests, results):
        got = np.asarray(reply["predictions"], np.float32)
        if got.shape != (len(payload["instances"]), hp["num_classes"]):
            raise AssertionError(f"reply shape {got.shape}")
        if not np.isfinite(got).all():
            raise AssertionError("non-finite logits")
    served = np.concatenate(
        [np.asarray(reply["predictions"], np.float32)
         for _, reply, _ in results])
    rows = served.shape[0]
    instances = [r for p in requests for r in p["instances"]]
    ids = np.asarray([r["input_ids"] for r in instances])
    mask = np.asarray([r["attention_mask"] for r in instances])
    dense = load_exported_model(dense_dir, device="cuda")
    flash = load_exported_model(os.path.join(base, "1"), device="cuda")

    def predict(loaded, mask_rows):
        return np.concatenate([
            loaded.predict({"input_ids": ids[i:i + 32],
                            "attention_mask": mask_rows[i:i + 32]})
            for i in range(0, rows, 32)])

    want = predict(dense, mask)
    max_err = float(np.abs(served - want).max())
    # Controls: the flash payload fed a wrong key mask — none (every pad
    # key attended) and each row's neighbour's — must miss the dense
    # logits by more than LOGIT_TOL, or the check could not catch a kernel
    # that ignored the mask or mixed up batch rows.
    controls = {
        "mask dropped": np.ones_like(mask),
        "mask of the next row": np.roll(mask, 1, axis=0),
    }
    control_err = {name: float(np.abs(predict(flash, m) - want).max())
                   for name, m in controls.items()}
    lat_ms = np.array([t for _, _, t in results]) * 1e3
    # Server-side mean (handler entry to reply) over warm-up + run, from the
    # server's own latency histogram.
    def scraped(name):
        return float(re.search(
            rf'^{name}{{endpoint="predict"}} (\S+)$', scrape, re.M)[1])
    server_ms = (scraped("serving_request_latency_seconds_sum")
                 / scraped("serving_request_latency_seconds_count") * 1e3)
    print(f"serving [{card}]: BERT-base (d_model {hp['d_model']}, "
          f"{hp['n_layers']} layers, {hp['n_heads']} heads, vocab "
          f"{hp['vocab_size']}) bf16, flash attention, L={SEQ_LEN}, "
          f"{N_CLIENT_PROCS * CLIENT_THREADS} concurrent clients: "
          f"{len(requests)} requests ({rows} rows) in {n_batches} device "
          f"batches; p50 {np.percentile(lat_ms, 50):.2f} ms, p99 "
          f"{np.percentile(lat_ms, 99):.2f} ms (server-side mean "
          f"{server_ms:.2f} ms); {rows / wall_s:.1f} examples/s; "
          f"peak device memory {peak_bytes} bytes", flush=True)
    print(f"serving: max |flash - dense| logit = {max_err:.3e} (tol {LOGIT_TOL:g}); "
          f"flash_fwd launches {launches} = {N_LAYERS} x {n_batches} batches "
          f"expected", flush=True)
    for name, err in control_err.items():
        print(f"serving control, {name}: max |flash - dense| logit = "
              f"{err:.3e} (must exceed tol {LOGIT_TOL:g})", flush=True)
    if max_err > LOGIT_TOL:
        raise AssertionError("flash-served logits disagree with dense")
    if min(control_err.values()) <= LOGIT_TOL:
        raise AssertionError(
            "a wrong key mask stays within LOGIT_TOL: the served check "
            "cannot tell a faulty kernel")
    if n_batches < 1 or launches != N_LAYERS * n_batches:
        raise AssertionError(
            f"flash_fwd launched {launches} times for {n_batches} batches")

    batch32 = {"input_ids": ids[:32], "attention_mask": mask[:32]}
    for name, loaded in (("flash", flash), ("dense", dense)):
        wall_ms, busy_ms, flash_ms, n_kernels = step_breakdown(loaded, batch32)
        print(f"serving step [{card}] {name} attention, batch 32 x {SEQ_LEN}: "
              f"host wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
              f"(idle share {1 - busy_ms / wall_ms:.3f}), flash_fwd "
              f"{flash_ms:.3f} ms, {n_kernels:.0f} kernels per step", flush=True)
    return launches


# ----------------------------------------------------------------- training

# Flash vs dense attention in the bf16 fine-tune, from the same init,
# batches and dropout generators: both round the softmax probabilities to
# bf16 before P.V, at different points (see LOGIT_TOL).  Three checks, each
# against two controls (flash fed no key mask, or each row's neighbour's)
# that must land above its tolerance; each tolerance sits near the
# geometric mean of the sound gap and the smaller control, measured on an
# H100 80GB HBM3 (700 W) at --seed 0 (the sound gaps in brackets are those
# of a forward that kept p in f32):
#   - GRAD_TOL bounds the relative L2 error of the first step's q/k/v
#     projection-weight gradients, which reach the weights only through
#     dq/dk/dv (sound 3.0e-2 [2.9e-2], controls 8.7e-1 and 1.04);
#   - MOMENT_TOL bounds the relative L2 error of AdamW's first moment of
#     every q/k/v projection weight after the whole train_loop run (the
#     loop's own optimizer state, an EMA of the gradients of all its
#     steps), the controls being train_loop runs fed the wrong masks
#     (sound 3.3e-2 [3.4e-2], controls 1.14 and 1.0);
#   - LOSS_TOL bounds the relative error of every step's loss in those
#     runs (sound 2.2e-3 [1.5e-3], controls 1.6e-1 and 3.8e-2).  Step 1 alone
#     cannot tell: at random init the loss stays near ln 2 whatever the
#     mask, and the runs part only as the classifier learns.
GRAD_TOL = 1.5e-1
MOMENT_TOL = 1.8e-1
LOSS_TOL = 1e-2
DEVICE = "cuda"


def training_batches(seed, vocab, n, batch=TRAIN_BATCH, length=SEQ_LEN):
    """``n`` batches of ``batch`` x ``length`` with ragged real lengths
    (8..length), pad id 0 behind them, and bench.py's label rule."""
    rng = np.random.default_rng(seed + 1)
    batches = []
    for _ in range(n):
        lengths = rng.integers(8, length + 1, size=batch)
        mask = np.arange(length)[None, :] < lengths[:, None]
        ids = np.where(mask, rng.integers(4, vocab, size=(batch, length)), 0)
        batches.append({
            "input_ids": ids.astype(np.int32),
            "attention_mask": mask.astype(np.int32),
            "label": (ids[:, 0] % 2).astype(np.int32),
        })
    return batches


QKV_WEIGHT = re.compile(r"\.attn\.(query|key|value)\.weight$")


def run_training(hp, seed, batches):
    """train_loop over ``batches``; returns (model, result, per-step losses,
    {q/k/v projection weight: AdamW's first moment after the run}, {calls
    of loss_fn, graph captures, graph replays in the run}, the run's
    capture seconds from train_compile_seconds_total)."""
    losses, optimizers = [], []
    calls = {"loss_fn": 0, "captures": 0, "replays": 0}
    capture_s = default_registry().counter(
        "train_compile_seconds_total", labels=("when",))
    capture_s0 = sum(capture_s.labels(w).get() for w in ("warmup", "steady"))

    def optimizer(params):
        optimizers.append(bert_module.adamw(TRAIN_LR)(params))
        return optimizers[-1]

    def loss_fn(*args):
        calls["loss_fn"] += 1
        return bert_module.loss_fn(*args)

    def counted(name, method):
        def wrapper(self, *args, **kwargs):
            calls[name] += 1
            return method(self, *args, **kwargs)
        return wrapper

    # The launches of the steps alone: read before the loop counts a step's
    # FLOPs (an eager forward and backward of its own).
    launches = {}
    loop_module = sys.modules[train_loop.__module__]
    real_count = loop_module.count_step_flops

    def counting(*args, **kwargs):
        launches.update(by_record(counters()))
        return real_count(*args, **kwargs)

    graph = torch.cuda.CUDAGraph
    with mock.patch.object(graph, "replay", counted("replays", graph.replay)), \
            mock.patch.object(graph, "capture_begin",
                              counted("captures", graph.capture_begin)), \
            mock.patch.object(loop_module, "count_step_flops", counting):
        model, result = train_loop(
            loss_fn=loss_fn,
            init_params_fn=functools.partial(bert_module.init_params_fn,
                                             hyperparameters=hp),
            optimizer=optimizer,
            train_iter=iter(batches),
            config=TrainLoopConfig(
                train_steps=len(batches), batch_size=TRAIN_BATCH, log_every=1,
                window_steps=TRAIN_WINDOW, anchor_every=TRAIN_WINDOW, seed=seed,
            ),
            metrics_cb=lambda step, m: losses.append(m["loss"]),
            device=DEVICE,
        )
    moments = {name: optimizers[0].state[p]["exp_avg"]
               for name, p in model.named_parameters()
               if QKV_WEIGHT.search(name)}
    seconds = sum(capture_s.labels(w).get() for w in ("warmup", "steady"))
    return model, result, losses, moments, calls, seconds - capture_s0


def eager_training(hp, seed, batches):
    """The same steps as ``run_training`` written out eagerly: the loop's
    init, the capturable AdamW, ``step_generator(seed, s)``, a synchronous
    copy of each batch.  Returns (per-step losses, the model, examples/s
    over the steps after the first TRAIN_WINDOW, peak device bytes)."""
    torch.cuda.reset_peak_memory_stats()
    model = bert_module.init_params_fn(
        torch.Generator().manual_seed(seed), batches[0], hyperparameters=hp)
    model.to(DEVICE).train()
    opt = bert_module.adamw(TRAIN_LR)(model.parameters())
    losses = []
    for s, batch in enumerate(batches):
        if s == TRAIN_WINDOW:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        dev_batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
        loss, _ = bert_module.loss_fn(model, dev_batch,
                                      step_generator(seed, s, DEVICE))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    eps = (len(batches) - TRAIN_WINDOW) * TRAIN_BATCH / (time.perf_counter() - t0)
    return ([x.item() for x in losses], model, eps,
            torch.cuda.max_memory_allocated())


def replay_step_breakdown(hp, seed, batch, iters=3):
    """The train loop's step object on one batch: the first step (eager,
    then the capture), then windows of TRAIN_WINDOW replays back to back
    with one synchronize each, as the loop runs them, profiled like
    train_step_breakdown and given per step: (wall_ms, profiled wall_ms,
    busy_ms, kernels per step)."""
    model = bert_module.init_params_fn(
        torch.Generator().manual_seed(seed), batch, hyperparameters=hp)
    model.to(DEVICE).train()
    state = TrainState(step=0, model=model, seed=seed,
                       optimizer=bert_module.adamw(TRAIN_LR)(model.parameters()))
    runner = _TrainStep(state, bert_module.loss_fn, torch.device(DEVICE),
                        torch.cuda.Stream(DEVICE))
    dev_batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    runner.run(dev_batch, 0)

    def window(i):
        for j in range(TRAIN_WINDOW):
            runner.run(dev_batch, 1 + i * TRAIN_WINDOW + j)
        torch.cuda.synchronize()

    wall_ms, profiled_ms, busy_ms, _, n_kernels = profiled(window, iters)
    return (wall_ms / TRAIN_WINDOW, profiled_ms / TRAIN_WINDOW,
            busy_ms / TRAIN_WINDOW, n_kernels / TRAIN_WINDOW)


def adamw_timing(model):
    """Device ms of one captured AdamW update of ``model``'s parameters,
    capturable foreach against capturable fused (optax's defaults, the
    learning rate of the run), each replayed from its own CUDA graph."""
    times = {}
    for fused in (False, True):
        params = [p.detach().clone().requires_grad_() for p in model.parameters()]
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen, device=DEVICE) * 1e-3
        opt = torch.optim.AdamW(params, lr=TRAIN_LR, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4, capturable=True,
                                fused=fused)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            opt.step()                       # builds the state
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            opt.step()
        times["fused" if fused else "foreach"] = time_ms(graph.replay, iters=20,
                                                         warmup=3)
        del opt, params, graph
    return times


def first_step_grads(hp, seed, batch):
    """Step 1's loss and q/k/v projection-weight gradients (the train
    loop's init and step-0 generator) for the model ``hp`` on ``batch``."""
    model = bert_module.init_params_fn(
        torch.Generator().manual_seed(seed), batch, hyperparameters=hp)
    model.to(DEVICE).train()
    loss, _ = bert_module.loss_fn(
        model, {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()},
        step_generator(seed, 0, DEVICE))
    loss.backward()
    return loss.item(), {
        name: p.grad for name, p in model.named_parameters()
        if QKV_WEIGHT.search(name)}


def rel_l2(got, want):
    return {name: (got[name] - w).norm().item() / w.norm().item()
            for name, w in want.items()}


def train_step_breakdown(hp, seed, batch, iters=3):
    """Host wall of one fine-tune step (forward, backward, AdamW; ends in a
    synchronize) and, from torch.profiler, its device time: (wall_ms,
    profiled wall_ms, busy_ms, {kernel: ms}, kernels per step)."""
    model = bert_module.init_params_fn(
        torch.Generator().manual_seed(seed), batch, hyperparameters=hp)
    model.to(DEVICE).train()
    opt = bert_module.adamw(TRAIN_LR)(model.parameters())
    dev_batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}

    def step(i):
        loss, _ = bert_module.loss_fn(model, dev_batch,
                                      step_generator(seed, i, DEVICE))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()

    wall_ms, profiled_ms, busy_ms, by_name, n_kernels = profiled(step, iters)
    by_kernel = {
        name: sum(us for kernel, us in by_name.items()
                  if re.search(rf"\b{name}(_mma)?_kernel\b", kernel)) / iters / 1e3
        for name in ("flash_fwd", "flash_bwd_dvec", "flash_bwd_dq",
                     "flash_bwd_dkv")
    }
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for kernel, us in top:
        print(f"training step top kernel: {us / iters / 1e3:.3f} ms/step "
              f"{kernel[:110]}", flush=True)
    return wall_ms, profiled_ms, busy_ms, by_kernel, n_kernels


def training_phase(seed, n_steps, card):
    """The slice's main path: BERT-base fine-tuning through train_loop with
    flash attention.  Returns the four kernels' launches in that run."""
    hp = {**DEFAULT_HPARAMS, "attn_impl": "flash", "max_len": SEQ_LEN,
          "num_classes": 2}
    batches = training_batches(seed, hp["vocab_size"], n_steps)

    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = fa.dvec_launches = 0
    model, result, losses, moments, calls, capture_s = run_training(
        hp, seed, batches)
    launches = {"flash_fwd": fa.launches, "flash_bwd_dvec": fa.dvec_launches,
                "flash_bwd_dq": fa.dq_launches,
                "flash_bwd_dkv": fa.dkv_launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    matmul_params = sum(
        p.numel() for name, p in model.named_parameters()
        if not re.search(r"(embed|pos_embed|type_embed)\.weight$", name))
    qkv = {name: p.detach().clone() for name, p in model.named_parameters()
           if QKV_WEIGHT.search(name)}
    adamw_ms = adamw_timing(model)
    del model

    # The graph run against the same steps written out eagerly (bit for
    # bit), a control re-seeded with the previous step's seed (must
    # differ), and a run whose last batch has another size (one capture
    # after warm-up).
    eager_losses, eager_model, eager_eps, eager_peak = eager_training(
        hp, seed, batches)
    qkv_equal = all(torch.equal(p, qkv[name])
                    for name, p in eager_model.named_parameters() if name in qkv)
    del eager_model
    with mock.patch("tpu_pipelines_torch.trainer.train_loop._step_seed",
                    lambda sd, st: _step_seed(sd, st - 1)):
        _, reseeded_result, reseeded_losses, _, _, _ = run_training(
            hp, seed, batches)
    reseeded_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(reseeded_losses, eager_losses))
    odd = training_batches(seed + 7, hp["vocab_size"], 1, batch=TRAIN_BATCH // 2)
    _, tail_result, tail_losses, _, tail_calls, tail_capture_s = run_training(
        hp, seed, batches[:TRAIN_WINDOW] + odd)

    _, dense_result, dense_losses, want_moments, _, _ = run_training(
        {**hp, "attn_impl": "dense"}, seed, batches)
    moment_err = rel_l2(moments, want_moments)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, dense_losses))

    want_loss, want = first_step_grads({**hp, "attn_impl": "dense"}, seed,
                                       batches[0])
    sound = rel_l2(first_step_grads(hp, seed, batches[0])[1], want)
    wrong_masks = {
        "mask dropped": np.ones_like,
        "mask of the next row": lambda m: np.roll(m, 1, axis=0),
    }
    control_err, control_loss, control_moment, control_run_loss = {}, {}, {}, {}
    for name, wrong in wrong_masks.items():
        fed = [{**b, "attention_mask": wrong(b["attention_mask"])}
               for b in batches]
        loss, grads = first_step_grads(hp, seed, fed[0])
        control_err[name] = max(rel_l2(grads, want).values())
        control_loss[name] = abs(loss - want_loss) / abs(want_loss)
        _, _, run_losses, got_moments, _, _ = run_training(hp, seed, fed)
        control_moment[name] = max(rel_l2(got_moments, want_moments).values())
        control_run_loss[name] = max(
            abs(a - b) / abs(b) for a, b in zip(run_losses, dense_losses))

    flops_per_step = bert_flops((matmul_params, hp["n_layers"], hp["d_model"]),
                                TRAIN_BATCH, SEQ_LEN)
    peak = _peak_flops_per_chip(DEVICE)
    eps = result.anchored_examples_per_sec_per_chip
    mfu = flops_per_step * eps / TRAIN_BATCH / peak if peak else None
    wall_ms, profiled_ms, busy_ms, by_kernel, n_kernels = train_step_breakdown(
        hp, seed, batches[0])
    r_wall_ms, r_profiled_ms, r_busy_ms, r_kernels = replay_step_breakdown(
        hp, seed, batches[0])

    print(f"training [{card}]: BERT-base (d_model {hp['d_model']}, "
          f"{hp['n_layers']} layers, {hp['n_heads']} heads, vocab "
          f"{hp['vocab_size']}) bf16, dropout {hp['dropout_rate']}, flash "
          f"attention, batch {TRAIN_BATCH} x {SEQ_LEN} ragged, AdamW "
          f"{TRAIN_LR:g}, {result.steps_completed} steps in windows of "
          f"{result.window_steps}", flush=True)
    print("training losses (flash): " + " ".join(f"{x:.5f}" for x in losses),
          flush=True)
    print("training losses (dense): " + " ".join(f"{x:.5f}" for x in dense_losses),
          flush=True)
    print(f"training: {result.anchored_examples_per_sec_per_chip} examples/s/chip "
          f"anchored over {result.anchor_windows} windows "
          f"({result.examples_per_sec_per_chip} whole-run; dense attention "
          f"{dense_result.anchored_examples_per_sec_per_chip} anchored); MFU "
          f"{'not measured' if mfu is None else f'{mfu:.4f}'} "
          f"({flops_per_step} analytic FLOP/step against {peak:g} FLOP/s); "
          f"peak device memory {peak_bytes} bytes", flush=True)
    print(f"training: launches {launches} = {N_LAYERS} x {len(losses)} steps "
          "expected for each, counted at replay", flush=True)
    print(f"training graph: {calls['captures']} capture, {calls['replays']} "
          f"replays, loss_fn called {calls['loss_fn']} times (the eager first "
          f"step and the capture), capture {capture_s:.3f} s, compiles after "
          f"warm {result.compiles_after_warm}; against the same steps run eagerly: "
          f"losses {'equal' if losses == eager_losses else 'DIFFER'} bit for "
          f"bit, final q/k/v weights {'equal' if qkv_equal else 'DIFFER'} bit "
          f"for bit; control re-seeded with step s-1's seed: max rel loss gap "
          f"{reseeded_gap:.3e} (must exceed 0)", flush=True)
    print(f"training graph, last batch of {TRAIN_BATCH // 2} rows after "
          f"{TRAIN_WINDOW} of {TRAIN_BATCH}: {tail_calls['captures']} captures, "
          f"{tail_calls['replays']} replays, captures {tail_capture_s:.3f} s, "
          f"compiles after warm {tail_result.compiles_after_warm}, losses "
          + " ".join(f"{x:.5f}" for x in tail_losses), flush=True)
    print(f"training throughput [{card}]: graph "
          f"{result.anchored_examples_per_sec_per_chip} and "
          f"{reseeded_result.anchored_examples_per_sec_per_chip} "
          f"examples/s/chip anchored (two runs of the same work), eager "
          f"{eager_eps:.2f} over the same steps; peak device memory graph "
          f"{peak_bytes} bytes, eager {eager_peak} bytes; AdamW update, "
          f"captured: foreach {adamw_ms['foreach']:.4f} ms, fused "
          f"{adamw_ms['fused']:.4f} ms (the loop's: fused)", flush=True)
    for name, err in sound.items():
        print(f"training grad {name}: rel L2 |flash - dense| = {err:.3e}")
    print(f"training: max rel L2 |flash - dense| q/k/v weight grad = "
          f"{max(sound.values()):.3e} (tol {GRAD_TOL:g}); after "
          f"{len(losses)} steps, max rel L2 |flash - dense| AdamW first "
          f"moment of the q/k/v weights = {max(moment_err.values()):.3e} "
          f"(tol {MOMENT_TOL:g}); max rel |flash - dense| loss = "
          f"{loss_err:.3e} (tol {LOSS_TOL:g})", flush=True)
    for name, err in control_err.items():
        print(f"training control, {name}: max rel L2 |flash - dense| q/k/v "
              f"weight grad = {err:.3e} (must exceed tol {GRAD_TOL:g}); "
              f"AdamW first moment = {control_moment[name]:.3e} (must exceed "
              f"tol {MOMENT_TOL:g}); loss rel err max over the run "
              f"{control_run_loss[name]:.3e} (must exceed tol {LOSS_TOL:g}), "
              f"at step 1 {control_loss[name]:.3e}", flush=True)
    print(f"training step [{card}] flash attention, batch {TRAIN_BATCH} x "
          f"{SEQ_LEN}: host wall {wall_ms:.3f} ms ({profiled_ms:.3f} ms "
          f"traced), device busy {busy_ms:.3f} ms traced (idle share "
          f"{1 - busy_ms / profiled_ms:.3f}), "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in by_kernel.items())
          + f", {n_kernels:.0f} kernels per step (eager)", flush=True)
    print(f"training step [{card}] graph replay, batch {TRAIN_BATCH} x "
          f"{SEQ_LEN}, windows of {TRAIN_WINDOW} replays: host wall "
          f"{r_wall_ms:.3f} ms ({r_profiled_ms:.3f} ms traced), device busy "
          f"{r_busy_ms:.3f} ms traced (idle share "
          f"{1 - r_busy_ms / r_profiled_ms:.3f}), {r_kernels:.0f} kernels per "
          "step", flush=True)

    if len(losses) != n_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"training losses not all finite: {losses}")
    expected = N_LAYERS * n_steps
    if any(n != expected for n in launches.values()):
        raise AssertionError(f"training launches {launches}, expected "
                             f"{expected} each")
    if (calls != {"loss_fn": 2, "captures": 1, "replays": n_steps - 1}
            or result.compiles_after_warm != 0):
        raise AssertionError(f"training: every step after the first must be a "
                             f"replay of one capture: {calls}, compiles after "
                             f"warm {result.compiles_after_warm}")
    if losses != eager_losses or not qkv_equal:
        raise AssertionError("training: the graph run differs from the same "
                             "steps run eagerly")
    if not reseeded_gap > 0:
        raise AssertionError("training: re-seeding the dropout generator with "
                             "the previous step's seed changes no loss: the "
                             "eager check cannot tell the masks")
    if (tail_result.compiles_after_warm != 1
            or tail_calls != {"loss_fn": 3, "captures": 2,
                              "replays": TRAIN_WINDOW}
            or not all(np.isfinite(tail_losses))):
        raise AssertionError(f"training: a last batch of another size must be "
                             f"captured once more: {tail_calls}, compiles "
                             f"after warm {tail_result.compiles_after_warm}")
    if (max(sound.values()) > GRAD_TOL
            or max(moment_err.values()) > MOMENT_TOL or loss_err > LOSS_TOL):
        raise AssertionError("flash-attention training disagrees with dense")
    if (min(control_err.values()) <= GRAD_TOL
            or min(control_moment.values()) <= MOMENT_TOL
            or min(control_run_loss.values()) <= LOSS_TOL):
        raise AssertionError(
            "a wrong key mask stays within GRAD_TOL, MOMENT_TOL or "
            "LOSS_TOL: the training check cannot tell a faulty kernel")
    return launches


# --------------------------------------------------------- generative serving

T5_LAYERS = t5m.DEFAULT_HPARAMS["n_layers"]
DECODE_LEN = 128
BEAM = 4
EOS_ID = 3
MAX_INPUT_LEN = 64
# Teacher-forced decoder logits, the served payload (flash decode) against
# the same weights with dense decode attention, bf16 compute: dense rounds
# the softmax probabilities to bf16 before P.V, the kernel keeps them in
# f32.  Two controls (the kernel handed the validity one position short, or
# the bias row of the next position) must land above it.  Set near the
# geometric mean of the sound gap and the smaller control, measured on an
# H100 80GB HBM3 (700 W) at --seed 0: sound 2.2e-3, controls 1.9e-1 (one
# short) and 6.5e-2 (next bias row); at random init the logits' scale is
# about 0.04.
DECODE_LOGIT_TOL = 1.2e-2


def t5_hparams(attn_impl):
    return {**t5m.DEFAULT_HPARAMS, "attn_impl": attn_impl, "beam_size": BEAM,
            "max_decode_len": DECODE_LEN, "eos_id": EOS_ID,
            "max_input_len": MAX_INPUT_LEN}


def t5_requests(rng, n_requests, vocab):
    """``:generate`` bodies of 1-4 rows, real input lengths 8..64, padded to
    MAX_INPUT_LEN behind an input_mask."""
    requests = []
    for _ in range(n_requests):
        rows = int(rng.integers(1, 5))
        lengths = rng.integers(8, MAX_INPUT_LEN + 1, size=rows)
        mask = np.arange(MAX_INPUT_LEN)[None, :] < lengths[:, None]
        ids = np.where(mask, rng.integers(4, vocab, size=(rows, MAX_INPUT_LEN)), 0)
        requests.append({"inputs": {"inputs": ids.tolist(),
                                    "input_mask": mask.astype(np.int32).tolist()}})
    return requests


def generated_tokens(tokens):
    """Tokens emitted per row: up to and including the first EOS."""
    out = 0
    for row in tokens:
        row = list(row)
        out += row.index(EOS_ID) + 1 if EOS_ID in row else len(row)
    return out


def validity_one_short(q, k, v, *, kv_mask, bias=None, block_k=None):
    """Control: the kernel loses the current token's own K/V."""
    short = kv_mask.clone()
    last = short.to(torch.int32).sum(dim=1) - 1
    rows = torch.arange(short.shape[0], device=short.device)
    short[rows, last.clamp_min(0)] = False
    return fa.flash_decode_attention(q, k, v, kv_mask=short, bias=bias,
                                     block_k=block_k)


def next_position_bias(rel_pos):
    """Control: the kernel gets the bias row of the next position."""
    def wrapper(q, k, v, *, kv_mask, bias=None, block_k=None):
        length = k.shape[1]
        pos = int(kv_mask[0].sum().item()) - 1    # every row at one position
        nxt = rel_pos(length + 1, length + 1, row=pos + 1)[..., :length]
        return fa.flash_decode_attention(q, k, v, kv_mask=kv_mask,
                                         bias=nxt.contiguous(), block_k=block_k)
    return wrapper


def kernel_as(wrapper):
    """Within the block the decoder's decode attention calls ``wrapper`` (a
    control around the kernel), or the kernel's own wrapper for None."""
    return mock.patch.object(tfm, "flash_decode_attention",
                             wrapper or fa.flash_decode_attention)


def teacher_forced_gaps(flash, dense, ids, mask, tokens,
                        decode_len=DECODE_LEN):
    """Feed ``tokens`` (the served output) step by step through the flash
    payload, the dense one and the flash one under each control; returns
    {run: max |logits - dense logits| over every step}."""
    runs = {
        "sound": None,
        "validity one short": validity_one_short,
        "bias of the next position": next_position_bias(
            flash.model.decoder.rel_pos),
    }
    ids = torch.as_tensor(ids, device=DEVICE)
    mask = torch.as_tensor(mask, device=DEVICE, dtype=torch.int32)
    tokens = torch.as_tensor(tokens, device=DEVICE).long()
    gaps = dict.fromkeys(runs, 0.0)
    with torch.inference_mode():
        states = {}
        for name, wrapper in [("dense", None), *runs.items()]:
            loaded = dense if name == "dense" else flash
            with kernel_as(wrapper):
                cache, encoded, logits = t5m.prefill_decode(
                    loaded.model, loaded.params, ids, mask, decode_len)
            states[name] = (loaded, wrapper, cache, encoded, logits)
        for t in range(decode_len):
            want = states["dense"][4]
            for name in runs:
                gaps[name] = max(gaps[name], (states[name][4] - want).abs()
                                 .max().item())
            if t + 1 == decode_len:
                break
            for name, (loaded, wrapper, cache, encoded, _) in states.items():
                with kernel_as(wrapper):
                    cache, logits = t5m._decode_one(
                        loaded.model, loaded.params, cache, tokens[:, t],
                        encoded, mask, t + 1, decode_len)
                states[name] = (loaded, wrapper, cache, encoded, logits)
    return gaps


def profiled(step, iters):
    """Host wall of ``step`` (which ends in a synchronize) and, from
    torch.profiler, the device time of the same steps: (wall_ms, profiled
    wall_ms, busy_ms, {kernel name: us summed})."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(2):
        step(i)
    t0 = time.perf_counter()
    for i in range(iters):
        step(i)
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(iters):
            step(i)
        profiled_ms = (time.perf_counter() - t0) / iters * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # Device busy = the union of kernel intervals (overlaps counted once),
    # against the host wall of the same profiled steps: tracing lengthens
    # both, so the idle share compares like with like.
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in kernels):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return wall_ms, profiled_ms, busy_us / iters / 1e3, by_name, len(kernels) / iters


def decode_step_breakdown(loaded, ids, mask, card):
    """One beam decode step at the served shape (4 rows x 4 beams, cache
    DECODE_LEN, position DECODE_LEN / 2), profiled."""
    ids = torch.as_tensor(ids[:4], device=DEVICE).repeat_interleave(BEAM, 0)
    mask = torch.as_tensor(mask[:4], device=DEVICE,
                           dtype=torch.int32).repeat_interleave(BEAM, 0)
    tok = torch.full((ids.shape[0],), 7, dtype=torch.long, device=DEVICE)
    with torch.inference_mode():
        cache, encoded, _ = t5m.prefill_decode(loaded.model, loaded.params, ids,
                                               mask, DECODE_LEN)

        def step(_):
            t5m._decode_one(loaded.model, loaded.params, cache, tok, encoded,
                            mask, DECODE_LEN // 2, DECODE_LEN)
            torch.cuda.synchronize()

        wall_ms, profiled_ms, busy_ms, by_name, n_kernels = profiled(step, 20)
    decode_ms = sum(us for name, us in by_name.items()
                    if "flash_decode_kernel" in name) / 20 / 1e3
    print(f"generate step [{card}] beam decode step, {ids.shape[0]} rows, cache "
          f"{DECODE_LEN}, position {DECODE_LEN // 2}: host wall {wall_ms:.3f} ms "
          f"({profiled_ms:.3f} ms traced), device busy {busy_ms:.3f} ms traced "
          f"(idle share {1 - busy_ms / profiled_ms:.3f}), flash_decode "
          f"{decode_ms:.4f} ms, {n_kernels:.0f} kernels per step", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"generate step top kernel: {us / 20 / 1e3:.4f} ms/step "
              f"{name[:110]}", flush=True)


def generate_phase(seed, n_requests, card, workdir):
    """T5-small beam search through ModelServer's :generate on the card.
    Returns (flash_decode launches over the served requests, the flash
    payload, every served row's (ids, mask) for the engine phase)."""
    hp = t5_hparams("flash")
    model = t5m.init_t5_weights(t5m.build_t5_model(hp),
                                torch.Generator().manual_seed(seed))
    state = model.state_dict()
    base = os.path.join(workdir, "t5")
    export_model(serving_model_dir=os.path.join(base, "1"), params=state,
                 module_file=T5_MODULE, hyperparameters=hp)
    dense_dir = os.path.join(workdir, "t5_dense", "1")
    export_model(serving_model_dir=dense_dir, params=state,
                 module_file=T5_MODULE, hyperparameters=t5_hparams("dense"))
    del model, state

    requests = t5_requests(np.random.default_rng(seed + 3), n_requests,
                           hp["vocab_size"])
    server = ModelServer("t5", base, device="cuda")
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/t5:generate"
        warm, _ = run_clients(url, requests[:1], n_procs=1, threads=1)
        if warm[0][0] != 200:
            raise AssertionError(f"warm-up request answered {warm[0][0]}")
        fa.decode_launches = 0
        results, wall_s = run_clients(url, requests, n_procs=2, threads=4)
        launches = fa.decode_launches
    finally:
        server.stop()

    codes = [c for c, _, _ in results]
    if any(c != 200 for c in codes):
        raise AssertionError(f"non-200 :generate replies: {sorted(set(codes))}")
    outputs = []
    for payload, (_, reply, _) in zip(requests, results):
        got = np.asarray(reply["outputs"])
        rows = len(payload["inputs"]["inputs"])
        if got.shape != (rows, DECODE_LEN) or got.dtype.kind != "i":
            raise AssertionError(f":generate reply shape {got.shape} {got.dtype}")
        outputs.append(got)
    tokens = np.concatenate(outputs)
    ids = np.concatenate([np.asarray(p["inputs"]["inputs"]) for p in requests])
    mask = np.concatenate([np.asarray(p["inputs"]["input_mask"])
                           for p in requests])
    # Each request runs DECODE_LEN decoder passes (the step-0 pass of
    # prefill_decode, then DECODE_LEN - 1 beam steps), each launching the
    # kernel once per decoder layer.
    expected = T5_LAYERS * DECODE_LEN * n_requests
    flash = load_exported_model(os.path.join(base, "1"), device="cuda")
    dense = load_exported_model(dense_dir, device="cuda")
    gaps = teacher_forced_gaps(flash, dense, ids, mask, tokens)
    lat_ms = np.array([t for _, _, t in results]) * 1e3
    n_tokens = generated_tokens(tokens)
    print(f"generate [{card}]: T5-small (d_model {hp['d_model']}, "
          f"{hp['n_layers']} + {hp['n_layers']} layers, {hp['n_heads']} heads, "
          f"vocab {hp['vocab_size']}) bf16, beam {BEAM}, max_decode_len "
          f"{DECODE_LEN}, flash decode, 8 concurrent clients: {n_requests} "
          f"requests ({tokens.shape[0]} rows, {n_tokens} generated tokens) in "
          f"{wall_s:.2f} s; p50 {np.percentile(lat_ms, 50):.1f} ms, p99 "
          f"{np.percentile(lat_ms, 99):.1f} ms; {n_tokens / wall_s:.1f} "
          f"generated tokens/s (the warm-up request, alone and first: "
          f"{warm[0][2] * 1e3:.1f} ms)", flush=True)
    print(f"generate: flash_decode launches {launches} = {T5_LAYERS} layers x "
          f"{DECODE_LEN} passes x {n_requests} requests expected", flush=True)
    print(f"generate: teacher-forced max |flash - dense| logit over "
          f"{DECODE_LEN} steps = {gaps['sound']:.3e} (tol "
          f"{DECODE_LOGIT_TOL:g})", flush=True)
    controls = {name: gap for name, gap in gaps.items() if name != "sound"}
    for name, gap in controls.items():
        print(f"generate control, {name}: max |flash - dense| logit = "
              f"{gap:.3e} (must exceed tol {DECODE_LOGIT_TOL:g})", flush=True)
    decode_step_breakdown(flash, ids, mask, card)
    if launches != expected:
        raise AssertionError(f"flash_decode launched {launches} times, "
                             f"expected {expected}")
    if gaps["sound"] > DECODE_LOGIT_TOL:
        raise AssertionError("flash-decoded logits disagree with dense")
    if min(controls.values()) <= DECODE_LOGIT_TOL:
        raise AssertionError(
            "a control stays within DECODE_LOGIT_TOL: the decode check cannot "
            "tell a faulty kernel")
    del dense
    return launches, flash


N_ENGINE_SEQS = 24


def engine_phase(loaded, seed, card):
    """The continuous-batching engine over the served payload's decode
    contract: 24 sequences with ragged prompts and budgets submitted from
    threads.  Returns the flash_decode launches of that traffic."""
    rng = np.random.default_rng(seed + 4)
    vocab = loaded.model.shared.num_embeddings
    prompts = [rng.integers(4, vocab, size=int(rng.integers(8, MAX_INPUT_LEN + 1)))
               for _ in range(N_ENGINE_SEQS)]
    budgets = [int(m) for m in rng.integers(DECODE_LEN // 8, DECODE_LEN + 1,
                                            size=N_ENGINE_SEQS)]
    engine = GenerativeEngine(loaded.decode_fns, loaded.params, device="cuda",
                              max_batch_size=8, page_size=DECODE_LEN // 4)
    try:
        engine.warm()
        fa.decode_launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            streams = list(pool.map(
                lambda i: engine.submit(prompts[i], max_new_tokens=budgets[i],
                                        timeout_s=600),
                range(N_ENGINE_SEQS)))
        wall_s = time.perf_counter() - t0
        launches = fa.decode_launches
        steps, prefills = engine.steps_run, engine.prefills_run
        compiles = engine.compiles_after_warm
        occupancy = engine.live_rows_total / max(1, engine.bucket_rows_total)
        buckets = sorted(engine._buckets_run)
    finally:
        engine.close()

    ended = all(
        (len(s) == m and EOS_ID not in s[:-1])
        or (len(s) <= m and s[-1] == EOS_ID and EOS_ID not in s[:-1])
        for s, m in zip((list(x) for x in streams), budgets))
    # Isolated greedy decodes of the same prompts (padded as the engine
    # pads them), each with its own budget.
    same = 0
    with torch.inference_mode():
        for prompt, budget, stream in zip(prompts, budgets, streams):
            ids = np.zeros((1, MAX_INPUT_LEN), np.int64)
            ids[0, :len(prompt)] = prompt
            greedy = t5m.make_greedy_generate(loaded.model, max_decode_len=budget,
                                              eos_id=EOS_ID)
            toks, _ = greedy(loaded.params, torch.as_tensor(ids, device=DEVICE),
                             torch.as_tensor(ids > 0, device=DEVICE).to(torch.int32))
            same += toks[0, :len(stream)].cpu().tolist() == stream.tolist()
    n_tokens = sum(len(s) for s in streams)
    print(f"engine [{card}]: GenerativeEngine, max_batch_size 8, page_size "
          f"{engine.page_size}, "
          f"{N_ENGINE_SEQS} sequences (prompts 8..{MAX_INPUT_LEN}, budgets "
          f"{min(budgets)}..{max(budgets)}) from 8 threads: {prefills} prefills, "
          f"{steps} steps in {wall_s:.2f} s; {steps / wall_s:.1f} steps/s, "
          f"{n_tokens / wall_s:.1f} tokens/s, mean occupancy {occupancy:.3f}; "
          f"buckets run {buckets}; compiles after warm {compiles}", flush=True)
    print(f"engine: {same} of {N_ENGINE_SEQS} streams equal the isolated greedy "
          f"decode (reported only: cuBLAS may pick other kernels at another "
          f"batch size); flash_decode launches {launches} = {T5_LAYERS} x "
          f"({prefills} prefills + {steps} steps) expected", flush=True)
    if not ended:
        raise AssertionError("an engine stream did not end at EOS or its budget")
    if prefills != N_ENGINE_SEQS or launches != T5_LAYERS * (prefills + steps):
        raise AssertionError(f"engine launched flash_decode {launches} times "
                             f"for {prefills} prefills and {steps} steps")
    if compiles != 0:
        raise AssertionError(f"{compiles} engine buckets first ran after warm()")
    return launches


# The long-cache engine run: T5-small's decode contract at a 2048-key cache
# (kv buckets 256/512/1024/2048), 8 sequences with budgets past 1024
# tokens, so the decode kernel runs with up to S = 8 splits per (row, head)
# and the last bucket reads more than 1024 keys per row.  Sequence i is
# submitted once the engine has run i * LONG_STAGGER steps, so the rows'
# positions are ragged (about 48 keys apart, across a split boundary at
# the 2048 bucket).
LONG_DECODE_LEN = 2048
LONG_PAGE = 256
N_LONG_SEQS = 8
LONG_BUDGETS = (1100, 1400)
LONG_STAGGER = 48


def split_lost(q, k, v, *, kv_mask, bias=None, block_k=None):
    """Control: the kernel loses the keys of the split that holds each
    row's current position (a merge that drops a rank)."""
    b, l, h, _ = k.shape
    ranges = fa.decode_split_ranges(
        l, fa.decode_splits(b, h, l, fa.sm_count(q.device)))
    short = kv_mask.clone()
    for row, last in enumerate((short.to(torch.int32).sum(dim=1) - 1).tolist()):
        lo, hi = next(r for r in ranges if r[0] <= last < r[1])
        short[row, lo:hi] = False
    return fa.flash_decode_attention(q, k, v, kv_mask=short, bias=bias,
                                     block_k=block_k)


def dense_decode(q, k, v, *, kv_mask, bias=None, block_k=None):
    """The decoder's dense decode attention, in the kernel's place."""
    return dense_attention(q, k, v, kv_mask=kv_mask, bias=bias)


def held(inner, ratios):
    """``inner`` (the kernel or a control around it) in the kernel's place,
    each call's output held against the plain version on the decoder's own
    inputs: ``ratios`` gets each call's max |out - ref| / OUT_TOL."""
    def wrapper(q, k, v, *, kv_mask, bias=None, block_k=None):
        out = inner(q, k, v, kv_mask=kv_mask, bias=bias, block_k=block_k)
        ref = fa.flash_decode_attention_reference(q, k, v, kv_mask=kv_mask,
                                                  bias=bias)
        ratios.append(tol_ratio(out, ref, OUT_TOL[q.dtype]))
        return out
    return wrapper


def engine_long_phase(loaded, seed, card):
    """The engine over the payload's weights at a 2048-key cache: 8
    sequences with budgets of 1100-1400 tokens from threads.  Every stream
    ends, launches = layers x (prefills + steps), the 2048 bucket runs, no
    bucket first runs after warm(); one step of the 2048 bucket whose
    deepest row is past 1024 keys (the rows at ragged positions) is
    replayed: the graph's own logits equal the same step run eagerly from a
    copy of its inputs bit for bit (the kernel held call by call against its
    plain version, within OUT_TOL) and sit within DECODE_LOGIT_TOL of dense
    decode attention on that copy, and two controls must miss OUT_TOL.
    Returns the flash_decode launches of the traffic."""
    hp = loaded.spec["hyperparameters"]
    fns = t5_module.make_decode_fns(loaded.model,
                                    {**hp, "max_decode_len": LONG_DECODE_LEN})
    run_step = fns.step
    captured = {}
    rng = np.random.default_rng(seed + 5)
    vocab = loaded.model.shared.num_embeddings
    prompts = [rng.integers(4, vocab, size=int(rng.integers(8, MAX_INPUT_LEN + 1)))
               for _ in range(N_LONG_SEQS)]
    budgets = [int(m) for m in rng.integers(LONG_BUDGETS[0], LONG_BUDGETS[1] + 1,
                                            size=N_LONG_SEQS)]
    engine = GenerativeEngine(fns, loaded.params, device="cuda",
                              max_batch_size=8, page_size=LONG_PAGE)
    bucket_step = engine._step

    def step(b, kv):
        # The first traffic step of the last bucket (its deepest row is past
        # 1024 keys, or a smaller bucket would do) replays the bucket's
        # graph: copy the arena rows it reads before it writes this step's
        # K/V, and the tokens and logits the replay leaves in the graph's
        # static outputs.
        if (captured.get("armed") and "inputs" not in captured
                and kv == LONG_DECODE_LEN):
            cache, tok, pos, live, encoded, enc_mask = engine._target.arena
            captured["inputs"] = (
                {n: (a[:b] if "cached_enc" in n else a[:b, :kv]).clone()
                 for n, a in cache.items()},
                tok[:b].clone(), pos[:b].clone(), encoded[:b].clone(),
                enc_mask[:b].clone())
            captured["live"] = live[:b].clone()
            nxt = bucket_step(b, kv)
            captured["tokens"] = nxt.clone()
            graph = engine._target.graphs.get((b, kv))
            if graph is not None:
                captured["logits"] = graph[2].float().clone()
            return nxt
        return bucket_step(b, kv)

    engine._step = step
    try:
        engine.warm()
        captured["armed"] = True
        fa.decode_launches = 0
        t0 = time.perf_counter()

        def submit(i):
            while engine.steps_run < i * LONG_STAGGER:
                time.sleep(0.001)
            return engine.submit(prompts[i], max_new_tokens=budgets[i],
                                 timeout_s=600)

        with ThreadPoolExecutor(N_LONG_SEQS) as pool:
            streams = list(pool.map(submit, range(N_LONG_SEQS)))
        wall_s = time.perf_counter() - t0
        launches = fa.decode_launches
        steps, prefills = engine.steps_run, engine.prefills_run
        compiles = engine.compiles_after_warm
        occupancy = engine.live_rows_total / max(1, engine.bucket_rows_total)
        buckets = sorted(engine._buckets_run)
        kv_buckets = engine.kv_buckets
    finally:
        engine.close()

    ended = all(
        (len(s) == m and EOS_ID not in s[:-1])
        or (len(s) <= m and s[-1] == EOS_ID and EOS_ID not in s[:-1])
        for s, m in zip((list(x) for x in streams), budgets))
    n_tokens = sum(len(s) for s in streams)
    if "inputs" not in captured:
        raise AssertionError("no traffic step ran the 2048-key bucket")
    if "logits" not in captured:
        raise AssertionError("the 2048-key bucket ran without its graph")
    cache, tok, pos, encoded, enc_mask = captured["inputs"]
    b = tok.shape[0]

    def replay(wrapper):
        with kernel_as(wrapper), torch.inference_mode():
            _, logits = run_step(loaded.params,
                                 {n: c.clone() for n, c in cache.items()}, tok,
                                 pos, encoded, enc_mask, LONG_DECODE_LEN)
        return logits.float()

    dense = replay(dense_decode)
    ratios = {name: [] for name in ("kernel", "validity one short",
                                    "split lost")}
    # The step run eagerly with the kernel on the copied rows: the graph's
    # logits, and the tokens it emitted, must be that run's bit for bit.
    flash = replay(held(fa.flash_decode_attention, ratios["kernel"]))
    graph_logits = captured["logits"]
    sound = (graph_logits - dense).abs().max().item()
    emitted = torch.where(captured["live"], flash.argmax(dim=-1),
                          engine.pad_id)
    graph_equal = bool(torch.equal(graph_logits, flash)
                       and torch.equal(emitted, captured["tokens"]))
    controls = {name: (replay(held(wrapper, ratios[name])) - dense)
                .abs().max().item()
                for name, wrapper in (("validity one short", validity_one_short),
                                      ("split lost", split_lost))}
    worst = {name: max(r) for name, r in ratios.items()}
    print(f"engine_long [{card}]: GenerativeEngine, max_batch_size 8, "
          f"max_decode_len {LONG_DECODE_LEN}, page_size {LONG_PAGE} (kv buckets "
          f"{kv_buckets}), {N_LONG_SEQS} sequences (budgets {min(budgets)}.."
          f"{max(budgets)}) from {N_LONG_SEQS} threads: {prefills} prefills, "
          f"{steps} steps in {wall_s:.2f} s; {steps / wall_s:.1f} steps/s, "
          f"{n_tokens / wall_s:.1f} tokens/s, mean occupancy {occupancy:.3f}; "
          f"buckets run {buckets}; compiles after warm {compiles}", flush=True)
    splits = fa.decode_splits(b, int(hp["n_heads"]), LONG_DECODE_LEN,
                              fa.sm_count("cuda"))
    print(f"engine_long: flash_decode launches {launches} = {T5_LAYERS} x "
          f"({prefills} prefills + {steps} steps) expected; splits at the "
          f"{LONG_DECODE_LEN} bucket S={splits}", flush=True)
    print(f"engine_long: replayed step at positions {pos.tolist()} (batch {b}, "
          f"kv {LONG_DECODE_LEN}): max |graph - dense| logit = {sound:.3e} "
          f"(tol {DECODE_LOGIT_TOL:g}); the graph's logits and tokens == the "
          f"eager step's bit for bit: {graph_equal}", flush=True)
    print(f"engine_long: replayed step, each of its {len(ratios['kernel'])} "
          f"decode calls held against the plain version: worst "
          f"{worst['kernel']:.3f} of OUT_TOL (at most 1)", flush=True)
    for name, gap in controls.items():
        must = "must exceed" if name == "split lost" else "reported"
        print(f"engine_long control, {name}: worst {worst[name]:.3f} of "
              f"OUT_TOL at the attention output (must exceed 1); max "
              f"|control - dense| logit = {gap:.3e} ({must} tol "
              f"{DECODE_LOGIT_TOL:g})", flush=True)
    if not ended:
        raise AssertionError("a long-cache stream did not end at EOS or its "
                             "budget")
    if prefills != N_LONG_SEQS or launches != T5_LAYERS * (prefills + steps):
        raise AssertionError(f"long-cache engine launched flash_decode "
                             f"{launches} times for {prefills} prefills and "
                             f"{steps} steps")
    if not any(kv == LONG_DECODE_LEN for _, kv in buckets):
        raise AssertionError(f"the {LONG_DECODE_LEN}-key bucket never ran")
    if compiles != 0:
        raise AssertionError(f"{compiles} long-cache buckets first ran after "
                             "warm()")
    if len(set(pos.tolist())) < 2:
        raise AssertionError("the replayed long-cache step has no ragged "
                             "positions")
    if worst["kernel"] > 1.0:
        raise AssertionError("the kernel disagrees with its plain version in "
                             "the replayed long-cache step")
    if not graph_equal:
        raise AssertionError("the long-cache step's graph gave other logits or "
                             "tokens than the same step run eagerly")
    if sound > DECODE_LOGIT_TOL:
        raise AssertionError("long-cache flash-decoded logits disagree with "
                             "dense")
    for name in ("validity one short", "split lost"):
        if worst[name] <= 1.0:
            raise AssertionError(f"the {name} control stays within OUT_TOL: "
                                 "the long-cache check cannot tell it")
    if controls["split lost"] <= DECODE_LOGIT_TOL:
        raise AssertionError("the split-lost control stays within "
                             "DECODE_LOGIT_TOL: the long-cache check cannot "
                             "tell a faulty merge")
    return launches


# ---------------------------------------------------- the engine's levers

# The engine_levers phase: the engine phase's payload and shapes (batch 8,
# pages of DECODE_LEN // 4, prompts 8..MAX_INPUT_LEN, budgets
# DECODE_LEN // 8..DECODE_LEN), LEVER_SEQS sequences of which the last
# LEVER_REPEATS repeat the first prompts (the prefix cache's hits).  The
# tight per-token SLO is LEVER_TIGHT of the lever-off run's mean step, the
# loose one LEVER_LOOSE times it: every sequence waits at most about three
# batches' decodes (LEVER_SEQS / 8 - 1) before it joins, far inside a
# budget of 16 or more tokens at LEVER_LOOSE steps a token.
LEVER_SEQS = 32
LEVER_REPEATS = 8
LEVER_SPEC = 4
LEVER_TIGHT = 0.5
LEVER_LOOSE = 100.0


def rescore(loaded, prompts, streams, replace=None):
    """The target's own verdict on emitted streams: every stream fed back
    through the decode contract in one batch (the prefill, then one step a
    position with the stream's tokens), and at every emitted position the
    greedy regret, max logit minus the emitted token's.  Returns the
    largest.  ``replace(t)`` swaps each stream's middle token first (the
    control: a stream that is not the target's greedy choice)."""
    fns = loaded.decode_fns
    n = len(streams)
    ids = np.zeros((n, MAX_INPUT_LEN), np.int64)
    width = max(len(s) for s in streams)
    toks = np.zeros((n, width), np.int64)
    valid = np.zeros((n, width), bool)
    for i, (p, s) in enumerate(zip(prompts, streams)):
        ids[i, :len(p)] = p
        s = list(s)
        if replace is not None:
            s[len(s) // 2] = replace(s[len(s) // 2])
        toks[i, :len(s)] = s
        valid[i, :len(s)] = True
    ids_t = torch.as_tensor(ids, device=DEVICE)
    mask = (ids_t > 0).to(torch.int32)
    toks_t = torch.as_tensor(toks, device=DEVICE)
    valid_t = torch.as_tensor(valid, device=DEVICE)
    worst = torch.zeros((), device=DEVICE)
    with torch.inference_mode():
        cache, encoded, logits = fns.prefill(loaded.params, ids_t, mask)
        for t in range(width):
            if t:
                pos = torch.full((n,), t, dtype=torch.long, device=DEVICE)
                cache, logits = fns.step(loaded.params, cache, toks_t[:, t - 1],
                                         pos, encoded, mask, fns.max_decode_len)
            lg = logits.float()
            regret = lg.max(-1).values - lg.gather(1, toks_t[:, t:t + 1])[:, 0]
            worst = torch.maximum(worst, torch.where(valid_t[:, t], regret, 0.0)
                                  .max())
    return float(worst)


def lever_run(loaded, prompts, budgets, **levers):
    """One engine (the engine phase's shapes) with ``levers``, warmed, then
    every sequence submitted from 8 threads; returns what the phase checks
    and reports."""
    from tpu_pipelines_torch.observability.metrics import MetricsRegistry
    from tpu_pipelines_torch.serving.generative import GenerationEvicted

    registry = MetricsRegistry()
    engine = GenerativeEngine(loaded.decode_fns, loaded.params, device=DEVICE,
                              max_batch_size=8, page_size=DECODE_LEN // 4,
                              registry=registry, **levers)

    def one(i):
        t0 = time.perf_counter()
        try:
            out = engine.submit(prompts[i], max_new_tokens=budgets[i],
                                timeout_s=600)
        except GenerationEvicted:
            return None, None
        return out.tolist(), (time.perf_counter() - t0) / len(out)

    try:
        t0 = time.perf_counter()
        engine.warm()
        warm_s = time.perf_counter() - t0
        zero_counters()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            results = list(pool.map(one, range(len(prompts))))
        wall_s = time.perf_counter() - t0
        launches = fa.decode_launches
        prefix = engine._prefix
        run = {
            "streams": [s for s, _ in results],
            "per_token_ms": [t * 1e3 for _, t in results if t is not None],
            "wall_s": wall_s, "warm_s": warm_s, "launches": launches,
            "steps": engine.steps_run, "prefills": engine.prefills_run,
            "runs": dict(engine.program_runs),
            "replay_launches": dict(engine.replay_launches),
            "compiles": engine.compiles_after_warm,
            "evictions": engine.evictions,
            "evicted_metric": registry.get(
                "serving_decode_evicted_total").labels("0").get(),
            "proposed": engine.spec_proposed, "accepted": engine.spec_accepted,
            "hits": prefix.hits if prefix else 0,
            "misses": prefix.misses if prefix else 0,
            "step_ms": engine.step_ewma_s * 1e3,
            "graphs": (len(engine._target.graphs)
                       + len(engine._draft.graphs if engine._draft else {})
                       + len(engine._verify_graphs)),
        }
    finally:
        engine.close()
    done = [s for s in run["streams"] if s is not None]
    run["tokens"] = sum(len(s) for s in done)
    run["ended"] = all(
        (len(s) == m and EOS_ID not in s[:-1])
        or (len(s) <= m and s[-1] == EOS_ID and EOS_ID not in s[:-1])
        for s, m in zip(run["streams"], budgets) if s is not None)
    return run


def engine_levers_phase(loaded, seed, card, surface_dir):
    """The engine's decode levers on T5-small's served payload, each run
    against the lever-off run; exports the payload into ``surface_dir``
    for the serving_surface phase.  Returns the flash_decode launches of
    the lever runs (summed) and the split by program kind."""
    rng = np.random.default_rng(seed + 17)
    vocab = loaded.model.shared.num_embeddings
    distinct = LEVER_SEQS - LEVER_REPEATS
    prompts = [rng.integers(4, vocab, size=int(rng.integers(8, MAX_INPUT_LEN + 1)))
               for _ in range(distinct)]
    prompts += prompts[:LEVER_REPEATS]
    budgets = [int(m) for m in rng.integers(DECODE_LEN // 8, DECODE_LEN + 1,
                                            size=LEVER_SEQS)]
    runs = {"off": lever_run(loaded, prompts, budgets)}
    step_ms = runs["off"]["step_ms"]
    runs["prefix_chunked"] = lever_run(
        loaded, prompts, budgets, prefix_cache_entries=LEVER_SEQS,
        prefill_chunk_pages=1)
    runs["spec_self_draft"] = lever_run(loaded, prompts, budgets,
                                        spec_tokens=LEVER_SPEC)
    runs["deadline_tight"] = lever_run(
        loaded, prompts, budgets, slo_ms_per_token=LEVER_TIGHT * step_ms,
        hard_deadline=True)
    runs["deadline_loose"] = lever_run(
        loaded, prompts, budgets, slo_ms_per_token=LEVER_LOOSE * step_ms,
        hard_deadline=True)
    off = runs["off"]["streams"]
    failures = []
    totals = {"target": 0, "draft": 0, "verify": 0, "prefill": 0}
    for name, run in runs.items():
        done = [(p, s) for p, s in zip(prompts, run["streams"]) if s is not None]
        regret, control = 0.0, float("inf")  # nothing emitted to rescore
        if done:
            regret = rescore(loaded, [p for p, _ in done], [s for _, s in done])
            control = rescore(loaded, [p for p, _ in done],
                              [s for _, s in done],
                              replace=lambda t: (t + vocab // 2) % vocab)
        same = sum(s == o for s, o in zip(run["streams"], off) if s is not None)
        lat = np.array(run["per_token_ms"] or [np.nan])
        spec = name.startswith("spec")
        prefill_passes = run["prefills"] * (2 if spec else 1)
        want = T5_LAYERS * (prefill_passes + run["runs"]["target"]
                            + run["runs"]["draft"])
        # The prefills' share is what the counter saw outside the replays;
        # the checks below (the total == want, each replay kind == T5_LAYERS
        # x its runs) hold it to T5_LAYERS x prefill_passes.
        prefill_launches = run["launches"] - sum(run["replay_launches"].values())
        for kind in totals:
            totals[kind] += (prefill_launches if kind == "prefill"
                             else run["replay_launches"][kind])
        print(f"engine_levers [{card}] {name}: {len(done)} of {LEVER_SEQS} "
              f"sequences done ({run['tokens']} tokens) in {run['wall_s']:.2f} "
              f"s, {run['tokens'] / run['wall_s']:.1f} tokens/s, per-token "
              f"latency p50 {np.percentile(lat, 50):.3f} ms p99 "
              f"{np.percentile(lat, 99):.3f} ms; {run['steps']} rounds (mean "
              f"step {run['step_ms']:.3f} ms), {run['prefills']} prefills, "
              f"{run['graphs']} graphs captured in a {run['warm_s']:.2f} s "
              f"warm-up, compiles after warm {run['compiles']}; prefix hits "
              f"{run['hits']} misses {run['misses']}; speculative "
              f"{run['accepted']}/{run['proposed']} accepted; evicted "
              f"{run['evictions']}; {same} streams equal the lever-off run's "
              f"(reported only: cuBLAS may pick other kernels at another "
              f"batch); greedy regret {regret:.3e} (tol {DECODE_LOGIT_TOL:g}; "
              f"a swapped middle token {control:.3e}); flash_decode "
              f"{run['launches']} = {T5_LAYERS} x ({prefill_passes} prefill "
              f"passes + {run['runs']['target']} target + "
              f"{run['runs']['draft']} draft steps), outside the replays "
              f"{prefill_launches}, from replays: target "
              f"{run['replay_launches']['target']}, draft "
              f"{run['replay_launches']['draft']}, verify "
              f"{run['replay_launches']['verify']} (the window runs dense)",
              flush=True)
        if run["compiles"] != 0:
            failures.append(f"{name}: {run['compiles']} compiles after warm")
        if not run["ended"]:
            failures.append(f"{name}: a stream did not end at EOS or budget")
        if run["launches"] != want or run["replay_launches"]["verify"] != 0:
            failures.append(f"{name}: launches {run['launches']} != {want}")
        if (run["replay_launches"]["target"] != T5_LAYERS * run["runs"]["target"]
                or run["replay_launches"]["draft"]
                != T5_LAYERS * run["runs"]["draft"]):
            failures.append(f"{name}: a step ran outside its graph")
        if regret > DECODE_LOGIT_TOL:
            failures.append(f"{name}: an emitted token {regret:.3e} below the "
                            "target's greedy choice")
        if control <= DECODE_LOGIT_TOL:
            failures.append(f"{name}: the swapped-token control stays within "
                            "DECODE_LOGIT_TOL")
        if run["evicted_metric"] != run["evictions"]:
            failures.append(f"{name}: serving_decode_evicted_total "
                            f"{run['evicted_metric']}")
    pc, sp = runs["prefix_chunked"], runs["spec_self_draft"]
    if (pc["hits"], pc["misses"]) != (LEVER_REPEATS, LEVER_SEQS - LEVER_REPEATS):
        failures.append(f"prefix cache {pc['hits']} hits {pc['misses']} misses")
    if pc["prefills"] != LEVER_SEQS - LEVER_REPEATS:
        failures.append(f"prefix cache: {pc['prefills']} prefills")
    if not sp["proposed"] or not sp["replay_launches"]["draft"]:
        failures.append("spec: no draft step replayed")
    if not runs["off"]["replay_launches"]["target"]:
        failures.append("off: no target step replayed")
    if not runs["deadline_tight"]["evictions"]:
        failures.append("tight deadline: nothing evicted")
    if runs["deadline_loose"]["evictions"]:
        failures.append("loose deadline: a stream evicted")
    print(f"engine_levers: acceptance rate "
          f"{sp['accepted'] / max(1, sp['proposed']):.4f} with self-draft at "
          f"k = {LEVER_SPEC}; tight SLO {LEVER_TIGHT * step_ms:.3f} ms/token "
          f"evicted {runs['deadline_tight']['evictions']}, loose "
          f"{LEVER_LOOSE * step_ms:.3f} ms/token evicted "
          f"{runs['deadline_loose']['evictions']}; flash_decode launches by "
          f"program over the runs: {totals}", flush=True)
    if failures:
        raise AssertionError(f"engine_levers: {failures}")
    export_model(serving_model_dir=os.path.join(surface_dir, "t5", "1"),
                 params=loaded.model.state_dict(), module_file=T5_MODULE,
                 hyperparameters=t5_hparams("flash"))
    return sum(r["launches"] for r in runs.values()), totals


# ------------------------------------------------------------------ taxi DAG

# Cut from a deployment's months of trips so that the whole script, with
# the fleet phases and the pipeline DAGs, stays within about 330 s on an
# H100 (250,000 rows until the retrain and fleet_guard phases came).
TAXI_ROWS = 150_000
TAXI_SAMPLE = os.path.join(REPO, "tests", "testdata", "taxi_sample.csv")
# Share of empty fields in the made CSV's trip_start_hour (a null int:
# NaN after the read, bucketized past the last boundary) and company (an
# empty string, a vocabulary term).  The reference preprocessing has no
# fill_missing, so an empty miles, fare or tips field would reach the model
# as NaN.
TAXI_EMPTY = 0.01
# Transform on the card vs apply_host, per output: the torch evaluator does
# the same f32 ops as numpy (+ - * / with f32 scalar operands, clamp,
# one-hot, the left-side search), so those outputs must be bit-equal.
# log1p is the card's libdevice log1pf against numpy's: at most
# TAXI_LOG1P_ULPS f32 ulps apart, and log_fare_z = (log1p(fare) - mean) /
# std carries that difference through exactly-rounded ops, so per element
# |card - host| <= TAXI_LOG1P_ULPS * ulp(log1p(fare)) / std + ulp(host).
TAXI_LOG1P_ULPS = 2
# The card's float64 analyzer states vs numpy's float64 (relative).
TAXI_STATE_RTOL = 1e-12
# The pushed payload's predictions (card vs CPU) and the Evaluator's
# metrics (card vs the same evaluation on the CPU).
TAXI_PRED_TOL = 1e-5


def taxi_csv(path, seed, rows):
    """A raw CSV with the taxi schema, ``rows`` rows made from ``seed``
    with the value ranges and category sets of tests/testdata's sample,
    with about TAXI_EMPTY empty fields in trip_start_hour and company."""
    import csv as csv_mod

    with open(TAXI_SAMPLE, newline="") as f:
        sample = list(csv_mod.DictReader(f))
    col = {k: [r[k] for r in sample] for k in sample[0]}
    rng = np.random.default_rng(seed)
    miles_hi = max(float(v) for v in col["trip_miles"])
    payments = sorted(set(col["payment_type"]))
    companies = sorted(set(col["company"]))
    miles = rng.uniform(0.1, miles_hi, rows)
    fare = 3.25 + 2.25 * miles + rng.uniform(0.0, 2.0, rows)
    hour = rng.integers(0, 24, rows)
    pay = rng.choice(payments, rows)
    tips = np.where(pay == "Cash", 0.0,
                    fare * rng.choice([0.0, 0.05, 0.15, 0.2], rows))
    text = {
        "trip_miles": np.char.mod("%.2f", miles),
        "fare": np.char.mod("%.2f", fare),
        "trip_start_hour": hour.astype("U"),
        "payment_type": pay,
        "company": rng.choice(companies, rows),
        "tips": np.char.mod("%.2f", tips),
    }
    for name in ("trip_start_hour", "company"):
        text[name] = np.where(rng.random(rows) < TAXI_EMPTY, "", text[name])
    header = list(text)
    lines = text[header[0]]
    for name in header[1:]:
        lines = np.char.add(np.char.add(lines, ","), text[name])
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        f.write("\n".join(lines.tolist()))
        f.write("\n")


def _f32_ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.spacing(x).astype(np.float64)


def held_to_host(host, got, bound, what):
    """``got`` (a Transform's outputs on the card) against ``host``
    (apply_host): every output bit for bit, dtypes included, but
    log_fare_z, held per element to ``bound``; returns log_fare_z's worst
    share of its bound (None without it).  ``what`` names the phase and
    the source in the messages."""
    ratio = None
    for name in host:
        a = np.asarray(host[name], np.float64)
        b = np.asarray(got[name], np.float64)
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"{what} {name} NaNs differ")
        diff = np.abs(np.nan_to_num(a) - np.nan_to_num(b))
        if name == "log_fare_z":
            ratio = float(np.nanmax(diff / bound))
            if ratio > 1.0:
                raise AssertionError(f"{what} log_fare_z at "
                                     f"{ratio:.3f} of its bound")
        elif diff.max() != 0 or host[name].dtype != got[name].dtype:
            raise AssertionError(
                f"{what} {name} not bit-equal to apply_host (max "
                f"|diff| {diff.max():.3e}, dtypes {host[name].dtype}/"
                f"{got[name].dtype})")
    return ratio


def transform_checks(graph_uri, raw_uri, materialized_uri, card):
    """The Transform on the card: the first chunk of each split as the
    Transform node materialized it, and as apply_device gives it now,
    against apply_host of the same raw rows (and a shifted-mean control
    that must miss); then the card's float64 analyzer states vs numpy's."""
    from tpu_pipelines_torch.data import examples_io
    from tpu_pipelines_torch.transform import graph as tg

    graph = tg.TransformGraph.load(graph_uri)
    zs = [n.id for n in graph.nodes if n.op == "z_score"]
    log1p_z = graph.outputs["log_fare_z"]
    for split in ("train", "eval"):
        # Output shard i is input shard i, chunk for chunk.
        chunk = next(examples_io.iter_column_chunks(raw_uri, split))
        materialized = next(examples_io.iter_column_chunks(
            materialized_uri, split))
        host = graph.apply_host(chunk)
        dev = graph.apply_device(chunk, "cuda")
        if graph.device_apply_active is not True:
            raise AssertionError("taxi_dag: the Transform graph did not run "
                                 "on the card")
        fare = np.asarray(chunk["fare"], np.float32)
        l_host = np.log1p(fare)
        l_dev = torch.log1p(torch.from_numpy(fare).cuda()).cpu().numpy()
        ok = ~np.isnan(l_host)
        ulps = np.abs(l_dev[ok].astype(np.float64) - l_host[ok]) / _f32_ulp(
            l_host[ok])
        if ulps.max() > TAXI_LOG1P_ULPS:
            raise AssertionError(f"taxi_dag: log1p {ulps.max()} ulps apart")
        std = float(graph.state[log1p_z]["std"])
        bound = (TAXI_LOG1P_ULPS * _f32_ulp(l_host) / std
                 + _f32_ulp(host["log_fare_z"]))
        node_ratio = held_to_host(host, materialized, bound,
                                  "taxi_dag: Transform node")
        dev_ratio = held_to_host(host, dev, bound, "taxi_dag: apply_device")
        # Control: every z-score mean shifted by one std must miss.
        shifted = tg.TransformGraph.load(graph_uri)
        for nid in zs:
            st = shifted.state[nid]
            st["mean"] = float(st["mean"]) + float(st["std"])
        ctl = shifted.apply_device(chunk, "cuda")
        ctl_ratio = float(np.nanmax(np.abs(
            np.asarray(ctl["log_fare_z"], np.float64)
            - np.asarray(host["log_fare_z"], np.float64)) / bound))
        ctl_miles = float(np.nanmax(np.abs(ctl["miles_z"] - host["miles_z"])))
        if ctl_ratio <= 1.0 or ctl_miles == 0.0:
            raise AssertionError("taxi_dag: the shifted-mean control did not "
                                 "miss the bound")
        print(f"taxi_dag transform [{card}] {split} chunk of "
              f"{len(fare)} rows: the Transform node's output and "
              f"apply_device == apply_host bit for bit on "
              f"{sorted(n for n in host if n != 'log_fare_z')}; log1p at most "
              f"{ulps.max():.0f} ulps apart, log_fare_z at {node_ratio:.3f} "
              f"(node) / {dev_ratio:.3f} of its bound; shifted-mean control "
              f"{ctl_ratio:.3e} of it (miles_z off by {ctl_miles:.3f})",
              flush=True)

    # The card's float64 analyzer states vs numpy float64 on the host.
    host_graph = tg.TransformGraph(graph.nodes, graph.outputs)
    host_graph.analyze_chunks(
        lambda: examples_io.iter_column_chunks(raw_uri, "train"), device=None)
    worst_rel = 0.0
    for nid, st in graph.state.items():
        for key, val in st.items():
            if key.startswith("_"):
                continue
            want = host_graph.state[nid][key]
            if key == "vocab":
                if list(val) != list(want):
                    raise AssertionError(f"taxi_dag: vocab #{nid} differs")
                continue
            a = np.asarray(val, np.float64)
            b = np.asarray(want, np.float64)
            rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))
                        ) if a.size else 0.0
            worst_rel = max(worst_rel, rel)
            if a.shape != b.shape or rel > TAXI_STATE_RTOL:
                raise AssertionError(
                    f"taxi_dag: analyzer #{nid} {key} card {a} vs host {b}")
    print(f"taxi_dag analyzers [{card}]: float64 states on the card vs numpy "
          f"on the host, worst relative difference {worst_rel:.3e} (bound "
          f"{TAXI_STATE_RTOL:g})", flush=True)
    return graph


def transform_rates(graph, raw_uri, card, n_chunks=16, phase="taxi_dag"):
    """Materialization rows/s over the train split's first chunks: the
    torch evaluator on the card vs apply_host; and one profiled chunk."""
    from tpu_pipelines_torch.data import examples_io

    chunks = []
    for chunk in examples_io.iter_column_chunks(raw_uri, "train"):
        chunks.append(chunk)
        if len(chunks) == n_chunks:
            break
    n_rows = [len(next(iter(c.values()))) for c in chunks]
    rows = sum(n_rows)
    graph.apply_device(chunks[0], "cuda")
    rates = {}
    for name, fn in (("card", lambda c: graph.apply_device(c, "cuda")),
                     ("apply_host", graph.apply_host)):
        t0 = time.perf_counter()
        for c in chunks:
            fn(c)
        rates[name] = rows / (time.perf_counter() - t0)

    def step(_):
        graph.apply_device(chunks[0], "cuda")
        torch.cuda.synchronize()

    wall_ms, profiled_ms, busy_ms, by_name, n_kernels = profiled(step, 5)
    print(f"{phase} transform rate [{card}]: {rates['card']:.0f} rows/s "
          f"through the card, {rates['apply_host']:.0f} rows/s apply_host "
          f"({len(chunks)} chunks, {rows} rows); one chunk of "
          f"{n_rows[0]} rows: host wall {wall_ms:.3f} ms "
          f"({profiled_ms:.3f} ms traced), device busy {busy_ms:.4f} ms "
          f"(idle share {1 - busy_ms / profiled_ms:.3f}), {n_kernels:.0f} "
          f"kernels", flush=True)
    return rates


def taxi_dag_phase(seed, card, workdir, rows=TAXI_ROWS):
    """The Chicago-taxi DAG on the card: all nine nodes through
    LocalDagRunner(device="cuda"), cold then warm, with the Transform, the
    Trainer and the served payload checked."""
    from tpu_pipelines_torch import trainer as trainer_pkg
    from tpu_pipelines_torch.components.evaluator import evaluate_payload
    from tpu_pipelines_torch.data import examples_io
    from tpu_pipelines_torch.evaluation.metrics import EvalOutcome
    from tpu_pipelines_torch.examples.taxi_pipeline import create_pipeline
    from tpu_pipelines_torch.metadata import open_store
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    base = os.path.join(workdir, "taxi")
    os.makedirs(base)
    csv_path = os.path.join(base, "taxi.csv")
    t0 = time.perf_counter()
    taxi_csv(csv_path, seed, rows)
    print(f"taxi_dag data: {rows} rows, {os.path.getsize(csv_path)} bytes of "
          f"CSV made in {time.perf_counter() - t0:.1f} s", flush=True)

    # The Trainer's run_fn calls train_loop and export_model through the
    # trainer package: record its logged losses and the device of the
    # exported params.
    seen = {"losses": [], "param_devices": set()}
    real_loop, real_export = trainer_pkg.train_loop, trainer_pkg.export_model

    def loop(**kw):
        def cb(step, metrics):
            seen["losses"] += [v for k, v in metrics.items() if "loss" in k]
        model, result = real_loop(metrics_cb=cb, **kw)
        seen["result"] = result
        return model, result

    def export(**kw):
        seen["param_devices"] |= {str(t.device) for t in kw["params"].values()}
        return real_export(**kw)

    with mock.patch.object(trainer_pkg, "train_loop", loop), \
            mock.patch.object(trainer_pkg, "export_model", export):
        t0 = time.perf_counter()
        cold = LocalDagRunner(device="cuda").run(create_pipeline(base, csv_path))
        cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = LocalDagRunner(device="cuda").run(create_pipeline(base, csv_path))
    warm_s = time.perf_counter() - t0
    statuses = {k: v.status for k, v in cold.nodes.items()}
    if len(statuses) != 9 or set(statuses.values()) != {"COMPLETE"}:
        raise AssertionError(f"taxi_dag: cold run {statuses}")
    if {v.status for v in warm.nodes.values()} != {"CACHED"}:
        raise AssertionError(
            f"taxi_dag: warm run {({k: v.status for k, v in warm.nodes.items()})}")
    print(f"taxi_dag nodes [{card}]: cold run {cold_s:.1f} s: " + ", ".join(
        f"{k} {v.wall_clock_s:.2f} s" for k, v in cold.nodes.items())
        + f"; warm run {warm_s:.2f} s, all 9 CACHED", flush=True)

    store = open_store(os.path.join(base, "metadata.sqlite"))
    try:
        props = {
            n: [e for e in store.get_executions(node_id=n)
                if e.state.value == "COMPLETE"][-1].properties
            for n in statuses
        }
    finally:
        store.close()
    out = {k: {key: arts[0].uri for key, arts in v.outputs.items()}
           for k, v in cold.nodes.items()}
    if not props["Evaluator"]["blessed"] or not props["InfraValidator"]["blessed"]:
        raise AssertionError(f"taxi_dag: not blessed: {props['Evaluator']}")
    if not props["Pusher"]["pushed"]:
        raise AssertionError(f"taxi_dag: not pushed: {props['Pusher']}")
    tprops = props["Transform"]
    if not tprops["materialize_on_device"] or tprops["device"] != "cuda":
        raise AssertionError(f"taxi_dag: Transform ran {tprops}")

    # Trainer: finite losses, params on the card, no capture after warm-up.
    result = seen["result"]
    losses = seen["losses"] + [props["Trainer"]["final_loss"],
                               props["Trainer"]["final_eval_loss"]]
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"taxi_dag: losses {losses}")
    if seen["param_devices"] != {"cuda:0"}:
        raise AssertionError(f"taxi_dag: exported params on "
                             f"{seen['param_devices']}")
    if result.compiles_after_warm != 0:
        raise AssertionError(f"taxi_dag: {result.compiles_after_warm} "
                             "captures after warm-up")
    print(f"taxi_dag trainer [{card}]: {result.steps_completed} steps at "
          f"batch 32, {result.examples_per_sec:.1f} examples/s, "
          f"{len(losses)} logged losses finite (last {losses[-3]:.4f}), "
          f"eval accuracy {props['Trainer']['final_eval_accuracy']:.4f}, "
          f"compiles after warm-up 0, exported params on cuda:0", flush=True)

    raw_uri = out["CsvExampleGen"]["examples"]
    graph = transform_checks(out["Transform"]["transform_graph"], raw_uri,
                             out["Transform"]["transformed_examples"], card)
    transform_rates(graph, raw_uri, card)

    # Served payload: the pushed version on the card vs on the CPU.
    pushed = props["Pusher"]["destination"]
    raw = next(examples_io.iter_column_chunks(raw_uri, "eval", rows=4096))
    on_card = load_exported_model(pushed, device="cuda").predict(raw)
    on_cpu = load_exported_model(pushed, device="cpu").predict(raw)
    gap = float(np.max(np.abs(on_card - on_cpu)))
    if on_card.shape != (len(raw["fare"]),) or gap > TAXI_PRED_TOL:
        raise AssertionError(f"taxi_dag: served predictions card vs CPU {gap}")

    # Evaluator: its metrics from the card vs the same evaluation on the CPU.
    model_uri = out["Trainer"]["model"]
    examples_uri = out["Transform"]["transformed_examples"]
    eval_props = {"label_key": "label_big_tip", "eval_split": "eval",
                  "batch_size": 512, "slice_columns": ["hour_bucket"],
                  "problem": "binary_classification"}
    card_metrics = EvalOutcome.load(out["Evaluator"]["evaluation"]).overall()
    n_eval = card_metrics.num_examples
    t0 = time.perf_counter()
    evaluate_payload(model_uri, examples_uri, eval_props, "cuda")
    eval_s = time.perf_counter() - t0
    cpu_metrics = evaluate_payload(model_uri, examples_uri, eval_props,
                                   "cpu").overall()
    metric_gap = max(abs(card_metrics.metrics[k] - cpu_metrics.metrics[k])
                     for k in card_metrics.metrics)
    if metric_gap > TAXI_PRED_TOL or cpu_metrics.num_examples != n_eval:
        raise AssertionError(f"taxi_dag: Evaluator card {card_metrics} vs "
                             f"CPU {cpu_metrics}")
    print(f"taxi_dag served [{card}]: pushed payload predicts {len(on_card)} "
          f"raw rows on the card within {gap:.3e} of the CPU (bound "
          f"{TAXI_PRED_TOL:g}); Evaluator accuracy "
          f"{card_metrics.metrics['accuracy']:.4f}, auc "
          f"{card_metrics.metrics['auc']:.4f} on {n_eval} examples, within "
          f"{metric_gap:.3e} of the CPU; evaluation {n_eval / eval_s:.0f} "
          f"examples/s on the card", flush=True)


# ------------------------------------------------------------------ BERT DAG

BERT_DAG_ROWS = 40_000
BERT_DAG_STEPS = 100
BERT_LEXICON = 3000
# Label-bearing words per review, drawn from its label's 20 words.
BERT_CUES = 3


def counters():
    return {name: getattr(fa, name) for name in fa.COUNTERS}


def zero_counters():
    for name in fa.COUNTERS:
        setattr(fa, name, 0)


def by_record(counts):
    """Launch counters under the kernels' record names."""
    return {"flash_fwd": counts["launches"],
            "flash_bwd_dvec": counts["dvec_launches"],
            "flash_bwd_dq": counts["dq_launches"],
            "flash_bwd_dkv": counts["dkv_launches"],
            "flash_decode": counts["decode_launches"]}


def made_up_words(rng, n):
    """``n`` distinct made-up words of 2-4 syllables, in a seeded order."""
    syllables = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]
    words = set()
    while len(words) < n:
        words.add("".join(rng.choice(syllables, int(rng.integers(2, 5)))))
    return list(rng.permutation(sorted(words)))


def review_text(i, text, lead):
    """Every tenth review holds a comma and every thirteenth a quotation
    after ``lead``, so a CSV of them has quoted fields to parse."""
    if i % 10 == 0:
        text = text.replace(" ", ", ", 1)
    if i % 13 == 0:
        text = f'{lead} "{text}"'
    return text


def quoted_text(i, text, lead):
    """``review_text`` as a quoted CSV field (inner quotes doubled)."""
    return '"' + review_text(i, text, lead).replace('"', '""') + '"'


def review_rows(seed, rows, part=0, lexicon=BERT_LEXICON):
    """``rows`` (text, label) reviews: 8-60 words from a made-up lexicon of
    ``lexicon`` words, BERT_CUES of them from the label's own 20 words (a
    real review corpus is not on the machine).  The lexicon comes from
    ``seed``; ``part`` > 0 draws other rows over the same lexicon."""
    rng = np.random.default_rng(seed)
    words = made_up_words(rng, lexicon)
    cues = (np.asarray(words[:20]), np.asarray(words[20:40]))
    filler = np.asarray(words[40:])
    if part:
        rng = np.random.default_rng([seed, part])
    labels = rng.integers(0, 2, rows)
    lengths = rng.integers(8, 61, rows)
    out = []
    for i in range(rows):
        picked = rng.choice(filler, lengths[i])
        at = rng.choice(lengths[i], BERT_CUES, replace=False)
        picked[at] = rng.choice(cues[labels[i]], BERT_CUES)
        out.append((" ".join(picked), int(labels[i])))
    return out


def reviews_csv(path, seed, rows):
    """``text,label`` reviews made from ``seed`` (``review_rows``)."""
    lines = ["text,label"]
    for i, (text, label) in enumerate(review_rows(seed, rows)):
        lines.append(f"{quoted_text(i, text, 'she wrote')},{label}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def payload_view(uri, dst, **hparams):
    """A view of the payload at ``uri`` with ``hparams`` in its spec: its
    files linked, its spec rewritten."""
    os.makedirs(dst)
    for name in os.listdir(uri):
        if name != "model_spec.json":
            os.symlink(os.path.join(uri, name), os.path.join(dst, name))
    with open(os.path.join(uri, "model_spec.json")) as f:
        spec = json.load(f)
    spec["hyperparameters"].update(hparams)
    with open(os.path.join(dst, "model_spec.json"), "w") as f:
        json.dump(spec, f)
    return dst


def run_dag(name, run_once, module_path, during_trainer=None, after_run=None):
    """The pipeline ``run_once()`` runs on the card, cold then warm (each
    run's ``RunResult`` read off ``LocalDagRunner.run``).  The kernels'
    counters are set to 0 just before the cold run and read just after it;
    the warm run must launch nothing.  ``during_trainer()``, if given, is
    called once inside the cold run's Trainer, ``after_run("cold")`` and
    ``after_run("warm")`` after each run's clock stops.  Returns (cold, cold
    seconds, warm, warm seconds, launches, seen: the Trainer's result,
    logged losses, its checkpoint savers, what ``during_trainer``
    returned, the counters when train_loop returned, CUDA graph captures
    and replays)."""
    import importlib

    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.utils.module_loader import load_module

    user = load_module(module_path)
    loop_module = importlib.import_module("tpu_pipelines_torch.trainer.train_loop")
    seen = {"losses": [], "savers": [], "captures": 0, "replays": 0}
    results = []
    real_loop, real_saver = user.train_loop, loop_module._AsyncCheckpointSaver
    real_run = LocalDagRunner.run
    graph = torch.cuda.CUDAGraph
    real_replay, real_capture = graph.replay, graph.capture_begin

    def loop(**kw):
        def cb(step, metrics):
            seen["losses"] += [v for k, v in metrics.items() if "loss" in k]
        if during_trainer is not None and "during" not in seen:
            seen["during"] = during_trainer()
        model, result = real_loop(metrics_cb=cb, **kw)
        seen["result"], seen["after_trainer"] = result, counters()
        return model, result

    class Saver(real_saver):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["savers"].append(self)

    def run(self, *args, **kwargs):
        results.append(real_run(self, *args, **kwargs))
        return results[-1]

    def counted(key, method):
        def wrapper(self, *args, **kwargs):
            seen[key] += 1
            return method(self, *args, **kwargs)
        return wrapper

    with mock.patch.object(LocalDagRunner, "run", run):
        with mock.patch.object(user, "train_loop", loop), \
                mock.patch.object(loop_module, "_AsyncCheckpointSaver", Saver), \
                mock.patch.object(graph, "replay", counted("replays", real_replay)), \
                mock.patch.object(graph, "capture_begin",
                                  counted("captures", real_capture)):
            zero_counters()
            t0 = time.perf_counter()
            run_once()
            cold_s = time.perf_counter() - t0
            launches = counters()
        if after_run is not None:
            after_run("cold")
        t0 = time.perf_counter()
        run_once()
        warm_s = time.perf_counter() - t0
        if after_run is not None:
            after_run("warm")
    cold, warm = results
    statuses = {k: v.status for k, v in cold.nodes.items()}
    if set(statuses.values()) != {"COMPLETE"}:
        raise AssertionError(f"{name}: cold run {statuses} "
                             + str({k: v.error[-2000:] for k, v in
                                    cold.nodes.items() if v.error}))
    if {v.status for v in warm.nodes.values()} != {"CACHED"}:
        raise AssertionError(
            f"{name}: warm run {({k: v.status for k, v in warm.nodes.items()})}")
    if counters() != launches:
        raise AssertionError(f"{name}: the warm run launched a kernel")
    return cold, cold_s, warm, warm_s, launches, seen


def save_seconds(name, seen, card):
    """Each checkpoint's seconds: the loop blocked (snapshot and fence
    wait) and the thread's write; every write finished."""
    saves = [rec for saver in seen["savers"] for rec in saver.saves]
    if not saves or any(rec["write_s"] is None for rec in saves):
        raise AssertionError(f"{name}: checkpoint saves {saves}")
    print(f"{name} checkpoints [{card}]: {len(saves)} saves written off the "
          "loop; " + "; ".join(
              f"step {rec['step']}: loop blocked {rec['blocked_s']:.4f} s, "
              f"written {rec['write_s']:.3f} s" for rec in saves)
          + f"; blocked {sum(r['blocked_s'] for r in saves):.4f} s in all",
          flush=True)
    return saves


def node_props(base, result):
    """Each node's execution properties in ``result`` (a RunResult), read
    from the pipeline's store ({} for a node with no execution)."""
    from tpu_pipelines_torch.metadata import open_store

    store = open_store(os.path.join(base, "metadata.sqlite"))
    try:
        return {n: (store.get_execution(nr.execution_id).properties
                    if nr.execution_id else {})
                for n, nr in result.nodes.items()}
    finally:
        store.close()


def trainer_checks(name, seen, steps):
    """The Trainer ran ``steps`` steps with finite losses, its first step
    eager, one capture and a replay for every later step, and no capture
    after warm-up."""
    result = seen["result"]
    if result.steps_completed != steps:
        raise AssertionError(f"{name}: {result.steps_completed} steps")
    if not seen["losses"] or not np.isfinite(seen["losses"]).all():
        raise AssertionError(f"{name}: losses {seen['losses']}")
    if (result.compiles_after_warm, seen["captures"], seen["replays"]) != (
            0, 1, steps - 1):
        raise AssertionError(
            f"{name}: {result.compiles_after_warm} compiles after warm-up, "
            f"{seen['captures']} captures, {seen['replays']} replays")


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cli(argv):
    """``python -m tpu_pipelines_torch`` in this process: (exit code,
    standard output)."""
    import contextlib
    import io

    from tpu_pipelines_torch.__main__ import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli_main(argv)
    return code, out.getvalue()


def scrape(port):
    """The run telemetry server's /metrics and /healthz, once."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        text = r.read().decode()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=10) as r:
        health = json.loads(r.read())
    found = sorted({line.split("{")[0].split(" ")[0]
                    for line in text.splitlines()
                    if line.startswith(("pipeline_nodes_", "pipeline_run_info"))})
    return found, health


def traced_run(name, root, want_ratio, outdir, tag):
    """``trace latest --json --perfetto --metrics`` of the newest run under
    ``root``: a node span for every node, a critical path, the cache-hit
    ratio ``want_ratio``, both files parse.  Returns the metrics."""
    perfetto = os.path.join(outdir, f"{tag}_trace.json")
    metrics_path = os.path.join(outdir, f"{tag}_metrics.json")
    code, out = cli(["trace", "latest", "--pipeline-root", root, "--json",
                     "--perfetto", perfetto, "--metrics", metrics_path])
    if code != 0:
        raise AssertionError(f"{name}: trace latest exited {code}")
    metrics = json.loads(out)
    with open(perfetto) as f:
        timeline = json.load(f)["traceEvents"]
    with open(metrics_path) as f:
        if json.load(f)["per_node"] != metrics["per_node"]:
            raise AssertionError(f"{name}: metrics.json differs from --json")
    if (not metrics["critical_path_nodes"]
            or metrics["cache_hit_ratio"] != want_ratio
            or not timeline):
        raise AssertionError(
            f"{name} {tag}: critical path {metrics['critical_path_nodes']}, "
            f"cache hit ratio {metrics['cache_hit_ratio']} (want "
            f"{want_ratio}), {len(timeline)} timeline events")
    return metrics


def trace_overhead(events):
    """Seconds the recorder spent writing ``events`` events, from the time
    of 2000 writes of a node-span-sized event to a file here."""
    from tpu_pipelines_torch.observability.trace import TraceRecorder

    with tempfile.TemporaryDirectory() as d:
        rec = TraceRecorder(d, "overhead")
        t0 = time.perf_counter()
        for i in range(2000):
            rec.complete("node", "scheduler", "Trainer", time.time(),
                         time.monotonic(), 0.5, args={
                             "status": "COMPLETE", "execution_id": i,
                             "retries": 0, "queue_wait_s": 0.0,
                             "gate_wait_s": 0.0, "upstream": ["Transform"]})
        per_event = (time.perf_counter() - t0) / 2000
        rec.close()
    return events * per_event, per_event


def bert_dag_phase(seed, card, workdir):
    """The BERT-base fine-tune DAG on the card as its users run it:
    ``python -m tpu_pipelines_torch run --pipeline-module
    tpu_pipelines_torch/examples/bert_pipeline.py`` (in this process) at
    BERT_BASE, the Trainer's ``attn_impl "auto"`` choosing by the crossover
    measured on this card, cold then warm, traced and read back with
    ``trace latest`` and ``inspect runs``.  Returns each kernel's launches
    in the cold run and its Trainer's model."""
    from tpu_pipelines_torch.components.evaluator import evaluate_payload
    from tpu_pipelines_torch.data import examples_io
    from tpu_pipelines_torch.data.input_pipeline import BatchIterator, InputConfig
    from tpu_pipelines_torch.evaluation.metrics import EvalOutcome
    from tpu_pipelines_torch.examples import bert_pipeline
    from tpu_pipelines_torch.transform.graph import TransformGraph

    base = os.path.join(workdir, "bert")
    csv_path = os.path.join(workdir, "reviews.csv")
    t0 = time.perf_counter()
    reviews_csv(csv_path, seed, BERT_DAG_ROWS)
    print(f"bert_dag data: {BERT_DAG_ROWS} reviews, "
          f"{os.path.getsize(csv_path)} bytes of CSV made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    hp = dict(bert_pipeline.BERT_BASE)
    port = free_port()
    env = {"TPP_PIPELINE_HOME": base, "BERT_DATA_CSV": csv_path,
           "BERT_TRAIN_STEPS": str(BERT_DAG_STEPS), "BERT_TINY": "",
           "TPP_METRICS_PORT": str(port)}
    pipeline_module = os.path.join(bert_pipeline.HERE, "bert_pipeline.py")
    root = os.path.join(base, "root")

    def run_once():
        with mock.patch.dict(os.environ, env):
            code, out = cli(["run", "--pipeline-module", pipeline_module,
                             "--device", DEVICE])
        if code != 0:
            raise AssertionError(f"bert_dag: run exited {code}: {out[-2000:]}")

    os.makedirs(base)
    traces = {}

    def read_trace(tag):
        traces[tag] = traced_run("bert_dag", root,
                                 0.0 if tag == "cold" else 1.0, workdir, tag)

    cold, cold_s, warm, warm_s, launches, seen = run_dag(
        "bert_dag", run_once,
        os.path.join(bert_pipeline.HERE, "bert_module.py"),
        during_trainer=lambda: scrape(port), after_run=read_trace)
    print(f"bert_dag nodes [{card}]: `python -m tpu_pipelines_torch run` "
          f"cold {cold_s:.1f} s: " + ", ".join(
              f"{k} {v.wall_clock_s:.2f} s" for k, v in cold.nodes.items())
          + f"; warm run {warm_s:.2f} s, all {len(cold.nodes)} CACHED, no "
          "kernel launched", flush=True)

    # The run trace, read back by the CLI: a node span for every node, the
    # critical path, cache hits 0.0 cold and 1.0 warm, the Trainer's
    # summaries; the telemetry server scraped during the cold run; both
    # runs listed by `inspect runs`.
    found, health = seen["during"]
    want_families = ["pipeline_nodes_done", "pipeline_nodes_failed",
                     "pipeline_nodes_pending", "pipeline_nodes_running",
                     "pipeline_run_info"]
    if found != want_families or not health.get("healthy"):
        raise AssertionError(f"bert_dag: TPP_METRICS_PORT scrape {found}, "
                             f"healthz {health}")
    tc = traces["cold"]
    telemetry = tc["train_telemetry"] or {}
    if (sorted(tc["per_node"]) != sorted(cold.nodes)
            or sorted(traces["warm"]["per_node"]) != sorted(cold.nodes)
            or tc["run_id"] != cold.run_id
            or traces["warm"]["run_id"] != warm.run_id
            or not tc["goodput"] or telemetry.get("compiles_after_warm") != 0
            or not tc["run_succeeded"]):
        raise AssertionError(f"bert_dag: cold trace {tc}")
    code, out = cli(["inspect", "runs", "bert-finetune", "--metadata",
                     os.path.join(base, "metadata.sqlite"), "--pipeline-root",
                     root, "--json"])
    listed = [r["run_id"] for r in json.loads(out)["runs"]]
    if code != 0 or listed != [cold.run_id, warm.run_id]:
        raise AssertionError(f"bert_dag: inspect runs {code} {listed}")
    overhead_s, per_event = trace_overhead(tc["events"])
    print(f"bert_dag trace [{card}]: cold {tc['events']} events, "
          f"{len(tc['per_node'])} node spans, critical path "
          f"{' -> '.join(tc['critical_path_nodes'])} "
          f"{tc['critical_path_measured_s']} s of run wall {tc['run_wall_s']} "
          f"s, cache hit ratio {tc['cache_hit_ratio']} cold, "
          f"{traces['warm']['cache_hit_ratio']} warm; goodput "
          f"{tc['goodput']['goodput']} ({tc['goodput']['source']}), "
          f"compiles after warm {telemetry['compiles_after_warm']}; "
          f"metadata ops {sum(o['count'] for o in tc['store_ops'].values())}; "
          f"perfetto and metrics files parse; recorder writes "
          f"{per_event * 1e6:.1f} us an event, {overhead_s * 1e3:.2f} ms "
          f"({overhead_s / cold_s:.2e} of the cold wall); scraped "
          f"{', '.join(found)} on :{port} during the run; inspect runs lists "
          f"{listed}", flush=True)
    props = node_props(base, cold)
    out = {k: {key: arts[0].uri for key, arts in v.outputs.items()}
           for k, v in cold.nodes.items()}
    BERT_DAG_OUTPUTS.update(out)
    raw_uri = out["CsvExampleGen"]["examples"]
    examples_uri = out["Transform"]["transformed_examples"]
    model_uri = out["Trainer"]["model"]
    tprops = props["Transform"]
    if not tprops["materialize_on_device"] or tprops["device"] != DEVICE:
        raise AssertionError(f"bert_dag: Transform ran {tprops}")

    # Launches from inside the runner: each step's four kernels (counted at
    # replay), the Trainer's end-of-run eval (whole batches) and the
    # Evaluator (every row) forward only.
    trainer_checks("bert_dag", seen, BERT_DAG_STEPS)
    n_eval = examples_io.num_rows(examples_uri, "eval")
    batch = hp["batch_size"]
    layers = DEFAULT_HPARAMS["n_layers"]
    # "auto" at the DAG's shapes, by the crossover recorded for this card.
    impl = tfm.choose_attn_impl(batch, DEFAULT_HPARAMS["n_heads"],
                                PIPELINE_LEN, PIPELINE_LEN, 2, torch.device(DEVICE))
    steps = layers * BERT_DAG_STEPS if impl == "flash" else 0
    trainer_fwd = steps + layers * (n_eval // batch) * (impl == "flash")
    want = {"launches": trainer_fwd
            + layers * -(-n_eval // batch) * (impl == "flash"),
            "dvec_launches": steps, "dq_launches": steps,
            "dkv_launches": steps, "decode_launches": 0}
    want_trainer = {**want, "launches": trainer_fwd}
    if launches != want or seen["after_trainer"] != want_trainer:
        raise AssertionError(
            f"bert_dag: launches {launches} (after the Trainer "
            f"{seen['after_trainer']}), expected {want} ({want_trainer}) for "
            f"auto = {impl}")
    result = seen["result"]
    tr = props["Trainer"]
    print(f"bert_dag launches: attn_impl auto chose {impl} at B={batch} "
          f"L={PIPELINE_LEN} (crossover {autotune_lookup()[0]}); {launches} = "
          + (f"{layers} layers x ({BERT_DAG_STEPS} steps + {n_eval // batch} "
             f"Trainer eval batches + {-(-n_eval // batch)} Evaluator "
             f"batches) forwards and {layers} x {BERT_DAG_STEPS} of each "
             "backward kernel" if impl == "flash" else "none: dense attention")
          + f"; the Trainer's step 1 eager, {seen['captures']} capture, "
          f"{seen['replays']} replays, compiles after warm-up "
          f"{result.compiles_after_warm}", flush=True)
    saves = save_seconds("bert_dag", seen, card)
    print(f"bert_dag trainer [{card}]: {result.steps_completed} steps at batch "
          f"{batch} x {PIPELINE_LEN}, {result.examples_per_sec:.1f} "
          f"examples/s over the run, losses "
          f"{seen['losses'][0]:.4f} -> {seen['losses'][-1]:.4f} "
          f"({len(seen['losses'])} logged, finite), Trainer eval accuracy "
          f"{tr['final_eval_accuracy']:.4f}; {len(saves)} checkpoints",
          flush=True)

    # The Transform on the card: the first chunk of each split as the node
    # materialized it and as apply_device gives it now, bit for bit equal
    # to apply_host.
    graph = TransformGraph.load(out["Transform"]["transform_graph"])
    truncated = 0
    for split in ("train", "eval"):
        chunk = next(examples_io.iter_column_chunks(raw_uri, split))
        materialized = next(examples_io.iter_column_chunks(examples_uri, split))
        host = graph.apply_host(chunk)
        dev = graph.apply_device(chunk, DEVICE)
        if graph.device_apply_active is not True:
            raise AssertionError("bert_dag: the Transform graph did not run "
                                 "on the card")
        held_to_host(host, materialized, None, "bert_dag: Transform node")
        held_to_host(host, dev, None, "bert_dag: apply_device")
        truncated += int((host["input_ids"][:, -1] != 0).sum())
        print(f"bert_dag transform [{card}] {split} chunk of "
              f"{len(chunk['text'])} rows: the Transform node's output and "
              f"apply_device == apply_host bit for bit on {sorted(host)}",
              flush=True)
    vocab = graph.tokenizer_vocab_sizes()["input_ids"]
    if not truncated or abs(vocab - BERT_LEXICON) > 64:
        raise AssertionError(f"bert_dag: vocab {vocab}, {truncated} rows "
                             "truncated")
    rates = transform_rates(graph, raw_uri, card, n_chunks=4, phase="bert_dag")
    print(f"bert_dag tokenize: learned vocabulary {vocab} (model vocab "
          f"{-(-vocab // 64) * 64}), {truncated} rows of the first chunks "
          f"truncated at {PIPELINE_LEN}; {rates['apply_host']:.0f} rows/s "
          "through apply_host", flush=True)

    # The payload: raw rows through its embedded graph == the materialized
    # rows, bit for bit.
    flash = load_exported_model(model_uri, device=DEVICE)
    raw = next(examples_io.iter_column_chunks(raw_uri, "eval", rows=batch))
    rows = next(examples_io.iter_column_chunks(examples_uri, "eval", rows=batch))
    from_raw = flash.predict(raw)
    if not np.array_equal(from_raw, flash.predict_transformed(rows)):
        raise AssertionError("bert_dag: predict(raw) != predict_transformed")

    # The Evaluator's metrics and logits against the same payload with dense
    # attention on the first two eval batches: logits within LOGIT_TOL, the
    # loss within 2 x LOGIT_TOL (cross-entropy moves by at most twice the
    # largest logit change), accuracy only by rows whose dense margin is
    # under 2 x LOGIT_TOL; the flash payload fed each row's mask shifted by
    # one key must miss LOGIT_TOL.
    dense_uri = payload_view(model_uri, os.path.join(workdir, "dense"),
                             attn_impl="dense")
    dense = load_exported_model(dense_uri, device=DEVICE)
    eval_props = {"label_key": "label", "eval_split": "eval",
                  "batch_size": batch, "slice_columns": None,
                  "problem": "multiclass", "max_eval_examples": 2 * batch}
    metrics = {name: evaluate_payload(uri, examples_uri, eval_props,
                                      DEVICE).overall().metrics
               for name, uri in (("flash", model_uri), ("dense", dense_uri))}
    gap = control = 0.0
    margins = []
    for i, b in enumerate(BatchIterator(examples_uri, "eval", InputConfig(
            batch_size=batch, shuffle=False, num_epochs=1,
            drop_remainder=False))):
        if i == 2:
            break
        want_logits = dense.predict_transformed(b)
        gap = max(gap, float(np.abs(flash.predict_transformed(b)
                                    - want_logits).max()))
        shifted = {**b, "attention_mask": np.roll(b["attention_mask"], 1, 1)}
        control = max(control, float(np.abs(flash.predict_transformed(shifted)
                                            - want_logits).max()))
        margins.append(np.abs(want_logits[:, 1] - want_logits[:, 0]))
    margins = np.concatenate(margins)
    near = int((margins < 2 * LOGIT_TOL).sum())
    loss_gap = abs(metrics["flash"]["loss"] - metrics["dense"]["loss"])
    acc_rows = abs(metrics["flash"]["accuracy"]
                   - metrics["dense"]["accuracy"]) * len(margins)
    print(f"bert_dag evaluator vs dense attention, first {len(margins)} eval "
          f"rows: max |logit gap| {gap:.3e} (tol {LOGIT_TOL:g}); loss "
          f"{metrics['flash']['loss']:.6f} vs {metrics['dense']['loss']:.6f} "
          f"(gap {loss_gap:.3e}, bound {2 * LOGIT_TOL:g}), accuracy "
          f"{metrics['flash']['accuracy']:.4f} vs "
          f"{metrics['dense']['accuracy']:.4f} ({acc_rows:.0f} rows apart, "
          f"{near} within the margin); shifted-mask control {control:.3e} "
          f"(must exceed {LOGIT_TOL:g})", flush=True)
    if gap > LOGIT_TOL or loss_gap > 2 * LOGIT_TOL or round(acc_rows) > near:
        raise AssertionError("bert_dag: the Evaluator with flash attention "
                             "disagrees with dense attention")
    if control <= LOGIT_TOL:
        raise AssertionError("bert_dag: the shifted-mask control stays within "
                             "LOGIT_TOL")
    del dense

    # The Evaluator node's metrics == the same evaluation now; its rate.
    node = EvalOutcome.load(out["Evaluator"]["evaluation"]).overall()
    full_props = {**eval_props, "max_eval_examples": 0}
    t0 = time.perf_counter()
    again = evaluate_payload(model_uri, examples_uri, full_props, DEVICE).overall()
    eval_s = time.perf_counter() - t0
    if node.num_examples != n_eval or node.metrics != again.metrics:
        raise AssertionError(f"bert_dag: Evaluator {node} vs now {again}")

    # A replayed step at the DAG's shape, profiled.
    hp_payload = flash.spec["hyperparameters"]
    del flash
    train_batch = next(examples_io.iter_column_chunks(examples_uri, "train",
                                                      rows=batch))
    wall_ms, profiled_ms, busy_ms, n_kernels = replay_step_breakdown(
        hp_payload, seed, train_batch)
    print(f"bert_dag evaluator [{card}]: accuracy "
          f"{node.metrics['accuracy']:.4f}, loss {node.metrics['loss']:.4f} on "
          f"{n_eval} eval rows, equal to the same evaluation now; "
          f"{n_eval / eval_s:.0f} examples/s (load included); a replayed "
          f"training step at batch {batch} x {PIPELINE_LEN}: host wall "
          f"{wall_ms:.3f} ms ({profiled_ms:.3f} ms traced), device busy "
          f"{busy_ms:.3f} ms (idle share {1 - busy_ms / profiled_ms:.3f}), "
          f"{n_kernels:.0f} kernels", flush=True)
    return by_record(launches), model_uri


# ------------------------------------------------------ the serving surface

# The serving_surface phase: SURFACE_REQUESTS :predict bodies of 1-2 rows
# per surface (REST and gRPC, raw and transformed) against BERT-base behind
# a two-replica fleet, each reply held against the payload's eager
# predict / predict_transformed at LOGIT_TOL; the BERT DAG rerun whose
# Trainer writes the metrics-history ring takes SURFACE_STEPS steps.
SURFACE_REQUESTS = 24
SURFACE_THREADS = 4
SURFACE_STEPS = 8
# Filled by bert_dag_phase: each node's outputs in its cold run.
BERT_DAG_OUTPUTS = {}


def grpc_clients(target, name, batches, threads=SURFACE_THREADS):
    """``batches`` through gRPC Predict from ``threads`` threads: [(replies
    in order, seconds each)], wall seconds."""
    from tpu_pipelines_torch.serving.grpc_server import PredictionClient

    client = PredictionClient(target)

    def one(batch):
        t0 = time.perf_counter()
        preds, _ = client.predict(name, batch, timeout=120)
        return preds, time.perf_counter() - t0

    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            out = list(pool.map(one, batches))
        return out, time.perf_counter() - t0
    finally:
        client.close()


def surface_requests(rng, rows, n):
    """``n`` request batches of 1-2 rows drawn from the columnar ``rows``."""
    count = len(next(iter(rows.values())))
    out = []
    for _ in range(n):
        pick = rng.integers(0, count, int(rng.integers(1, 3)))
        out.append({k: np.asarray(v)[pick] for k, v in rows.items()})
    return out


def as_rest(batch):
    n = len(next(iter(batch.values())))
    return {"instances": [{k: np.asarray(v[i]).tolist() for k, v in batch.items()}
                          for i in range(n)]}


def surface_predicts(card, name, base, loaded_fn, batches, trace_dir, **kwargs):
    """One BERT fleet serving ``batches`` over REST and gRPC (after one
    warm-up request that captures its buckets): replies held against
    ``loaded_fn`` (the payload's eager predict or predict_transformed);
    returns (failures, p50 ms by surface, launches, device batches)."""
    from tpu_pipelines_torch.serving.grpc_server import start_grpc_server

    server = ModelServer("bert", base, replicas=FLEET_REPLICAS, max_versions=2,
                         max_batch_size=FLEET_BATCH, request_trace_mode="all",
                         trace_dir=trace_dir, device=DEVICE, **kwargs)
    fleet = server._fleet
    failures = []
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/bert:predict"
        grpc_server, gport = start_grpc_server(server)
        try:
            warm, _ = run_clients(url, [as_rest(batches[0])], n_procs=1,
                                  threads=1)
            if warm[0][0] != 200:
                raise AssertionError(f"{name}: warm-up answered {warm[0][0]}")
            zero_counters()
            batches0 = served_batches(fleet)
            rest, rest_s = run_clients(url, [as_rest(b) for b in batches],
                                       n_procs=1, threads=SURFACE_THREADS)
            grpc_out, grpc_s = grpc_clients(f"127.0.0.1:{gport}", "bert",
                                            batches)
            launches, n_batches = counters(), served_batches(fleet) - batches0
            text = server.metrics_text()
        finally:
            grpc_server.stop(grace=2)
    finally:
        server.stop()
    gaps = {"rest": 0.0, "grpc": 0.0}
    for b, (code, reply, _), (preds, _) in zip(batches, rest, grpc_out):
        want = np.asarray(loaded_fn(b), np.float32)
        if code != 200:
            failures.append(f"{name}: REST answered {code}")
            continue
        gaps["rest"] = max(gaps["rest"], float(np.abs(
            np.asarray(reply["predictions"], np.float32) - want).max()))
        gaps["grpc"] = max(gaps["grpc"], float(np.abs(
            np.asarray(preds, np.float32) - want).max()))
    p50 = {"rest": float(np.median([t for _, _, t in rest])) * 1e3,
           "grpc": float(np.median([t for _, t in grpc_out])) * 1e3}
    rows = sum(len(next(iter(b.values()))) for b in batches)
    print(f"serving_surface [{card}] {name}: BERT-base behind "
          f"{FLEET_REPLICAS} replicas, {len(batches)} requests ({rows} rows) "
          f"over REST and as many over gRPC from {SURFACE_THREADS} threads "
          f"each: p50 REST {p50['rest']:.2f} ms, gRPC {p50['grpc']:.2f} ms; "
          f"max |reply - eager| REST {gaps['rest']:.3e}, gRPC "
          f"{gaps['grpc']:.3e} (tol {LOGIT_TOL:g}); {launches['launches']} "
          f"flash_fwd launches over {n_batches} device batches", flush=True)
    if max(gaps.values()) > LOGIT_TOL:
        failures.append(f"{name}: replies {gaps} off the eager predict")
    try:
        check_served_launches(f"serving_surface {name}", launches, n_batches)
    except AssertionError as e:
        failures.append(str(e))
    if "# exemplar serving_request_latency_seconds" not in text:
        failures.append(f"{name}: no exemplar on /metrics")
    return failures, p50, launches["launches"], n_batches


def surface_generate(card, t5_base, trace_dir):
    """T5-small as the generative model type with every engine lever on,
    behind REST :generate and gRPC Generate / GetModelStatus / Reload.  The
    served streams are rescored by the target (greedy regret within
    DECODE_LOGIT_TOL, a swapped middle token outside it), and each
    version's flash_decode launches, counted over its generates alone (the
    counters zeroed after the Reload's warm-up), equal T5_LAYERS x (two
    prefill passes a prefill + target and draft replays) of its engines."""
    from tpu_pipelines_torch.serving.grpc_server import (
        PredictionClient,
        start_grpc_server,
    )

    with open(os.path.join(t5_base, "1", "model_spec.json")) as f:
        vocab = json.load(f)["hyperparameters"]["vocab_size"]
    rng = np.random.default_rng(7)
    lengths = np.array([[12], [40], [MAX_INPUT_LEN]])
    ids = np.where(np.arange(MAX_INPUT_LEN)[None, :] < lengths,
                   rng.integers(4, vocab, size=(3, MAX_INPUT_LEN)), 0)
    batch = {"inputs": ids, "input_mask": (ids > 0).astype(np.int32)}
    server = ModelServer(
        "t5", t5_base, model_type="generative", max_batch_size=8,
        decode_page_size=DECODE_LEN // 4, spec_tokens=LEVER_SPEC,
        prefix_cache_entries=16, prefill_chunk_pages=1,
        slo_ms_per_token=60_000.0, hard_deadline=True,
        request_trace_mode="all", trace_dir=trace_dir, device=DEVICE)

    def counted(version):
        """What the version's engines did since the counters were zeroed."""
        engines = [r._engines[version] for r in server._fleet.pool.replicas
                   if version in r._engines]
        return {
            "launches": fa.decode_launches,
            "want": T5_LAYERS * sum(2 * e.prefills_run
                                    + e.program_runs["target"]
                                    + e.program_runs["draft"] for e in engines),
            "compiles": sum(e.compiles_after_warm for e in engines),
            "accepted": sum(e.spec_accepted for e in engines),
            "proposed": sum(e.spec_proposed for e in engines),
            "draft": sum(e.replay_launches["draft"] for e in engines),
        }

    failures = []
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/t5:generate"
        grpc_server, gport = start_grpc_server(server)
        client = PredictionClient(f"127.0.0.1:{gport}")
        try:
            zero_counters()
            results, _ = run_clients(
                url, [{"inputs": {k: v.tolist() for k, v in batch.items()}}],
                n_procs=1, threads=1)
            (code, reply, rest_s), = results
            t0 = time.perf_counter()
            tokens, version = client.generate("t5", batch, timeout=300)
            grpc_s = time.perf_counter() - t0
            status = client.model_status("t5")
            runs = {"1": counted("1")}
            payload_copy(os.path.join(t5_base, "1"), os.path.join(t5_base, "2"))
            reloaded = client.reload("t5", timeout=600)
            after = client.model_status("t5")
            zero_counters()
            again, version2 = client.generate("t5", batch, timeout=300)
            runs["2"] = counted("2")
        finally:
            client.close()
            grpc_server.stop(grace=2)
    finally:
        server.stop()
    rest_tokens = np.asarray(reply["outputs"]) if code == 200 else None
    loaded = load_exported_model(os.path.join(t5_base, "1"), device=DEVICE)
    prompts = [row[:n] for row, (n,) in zip(ids, lengths)]
    streams = [row[:row.index(EOS_ID) + 1] if EOS_ID in row else row
               for row in tokens.tolist()]
    regret = rescore(loaded, prompts, streams)
    control = rescore(loaded, prompts, streams,
                      replace=lambda t: (t + vocab // 2) % vocab)
    del loaded
    total = {k: sum(r[k] for r in runs.values()) for k in runs["1"]}
    print(f"serving_surface [{card}] t5 generative (spec_tokens {LEVER_SPEC}, "
          f"prefix cache, chunked prefill, loose per-token SLO under "
          f"hard_deadline): REST :generate {code} in {rest_s * 1e3:.1f} ms, "
          f"gRPC Generate {tokens.shape} in {grpc_s * 1e3:.1f} ms, equal "
          f"{rest_tokens is not None and np.array_equal(rest_tokens, tokens)}; "
          f"GetModelStatus {status}; Reload {reloaded} -> status {after}; "
          f"Generate on version {version2} equal "
          f"{np.array_equal(again, tokens)}; greedy regret {regret:.3e} (tol "
          f"{DECODE_LOGIT_TOL:g}; a swapped middle token {control:.3e}); "
          f"acceptance {total['accepted']}/{total['proposed']}; flash_decode "
          + ", ".join(f"version {v} {r['launches']} (want {r['want']}, draft "
                      f"lane {r['draft']})" for v, r in runs.items())
          + f"; compiles after warm {total['compiles']}", flush=True)
    if code != 200 or not np.array_equal(rest_tokens, tokens):
        failures.append("t5: REST :generate and gRPC Generate differ")
    if status != {"version": "1", "state": "AVAILABLE"} or version != "1":
        failures.append(f"t5: status {status}, version {version}")
    if reloaded["version"] != "2" or after["version"] != "2" or version2 != "2":
        failures.append(f"t5: reload {reloaded}, status {after}")
    if not np.array_equal(again, tokens):
        failures.append("t5: version 2 (the same weights) decoded otherwise")
    if regret > DECODE_LOGIT_TOL:
        failures.append(f"t5: a served token {regret:.3e} below the target's "
                        "greedy choice")
    if control <= DECODE_LOGIT_TOL:
        failures.append("t5: the swapped-token control stays within "
                        "DECODE_LOGIT_TOL")
    for v, r in runs.items():
        if r["launches"] != r["want"] or not r["draft"]:
            failures.append(f"t5 version {v}: flash_decode {r['launches']} "
                            f"!= {r['want']}, draft lane {r['draft']}")
    if total["compiles"] or not total["proposed"]:
        failures.append(f"t5: compiles {total['compiles']}, proposed "
                        f"{total['proposed']}")
    return failures, total["launches"]


def surface_trace_serve(trace_dir, n_traced):
    """``python -m tpu_pipelines_torch trace serve`` reads the traces back:
    every traced request's chain complete."""
    code, out = cli(["trace", "serve", trace_dir, "--json"])
    doc = json.loads(out) if code == 0 else {}
    traces = doc.get("traces", {}).values()
    predict = [t for t in traces if t.get("endpoint") == "predict"]
    generate = [t for t in traces if t.get("endpoint") == "generate"]
    incomplete = []
    for t in predict:
        spans = {s["name"] for s in t["spans"]}
        instants = {s["name"] for s in t["instants"]}
        # REST requests pass admission control, gRPC calls go straight to
        # the fleet (as in the reference).
        want = {"admission", "route"} if t.get("code") == 200 else {"route"}
        if (t.get("code") not in (200, "OK") or not {"batch.wait", "model.step"}
                <= spans or not want <= instants or t.get("version") is None):
            incomplete.append(t["trace_id"])
    for t in generate:
        spans = {s["name"] for s in t["spans"]}
        if t.get("code") not in (200, "OK") or not {"decode", "decode.join"} <= spans:
            incomplete.append(t["trace_id"])
    print(f"serving_surface trace serve: exit {code}, "
          f"{doc.get('trace_count')} traces ({len(predict)} predict, "
          f"{len(generate)} generate; {len(doc.get('exemplars', []))} "
          f"exemplars), {len(incomplete)} with a chain missing a span",
          flush=True)
    failures = []
    if code != 0 or len(predict) != n_traced or incomplete or not generate:
        failures.append(f"trace serve: exit {code}, {len(predict)} of "
                        f"{n_traced} predict traces, incomplete {incomplete[:3]}")
    return failures


def surface_infra(card, model_uri, outputs, workdir):
    """The InfraValidator over gRPC on the Transform's examples
    (``raw_examples=False``); the CPU tests run every binary and both
    example kinds."""
    from tpu_pipelines_torch.components.infra_validator import InfraValidator
    from tpu_pipelines_torch.dsl.component import ExecutorContext
    from tpu_pipelines_torch.metadata.types import Artifact

    params = {k: p.default for k, p in InfraValidator.SPEC.parameters.items()}
    params.update(serving_binary="grpc", raw_examples=False)
    out = tempfile.mkdtemp(dir=workdir)
    ctx = ExecutorContext(
        node_id="InfraValidator",
        inputs={"model": [Artifact("Model", model_uri)],
                "examples": [Artifact(
                    "Examples", outputs["Transform"]["transformed_examples"])]},
        outputs={"blessing": [Artifact(type_name="InfraBlessing", uri=out)]},
        exec_properties=params, extras={"device": DEVICE})
    props = InfraValidator.EXECUTOR(ctx)
    print(f"serving_surface [{card}] InfraValidator binary grpc, "
          f"raw_examples False: blessed {props['blessed']}, p50 "
          f"{props.get('latency_p50_ms', float('nan')):.2f} ms, p95 "
          f"{props.get('latency_p95_ms', float('nan')):.2f} ms", flush=True)
    return [] if props["blessed"] else [f"InfraValidator grpc raw=False: {props}"]


def surface_export(card, flash_uri, raw_rows, workdir):
    """The payload's device step as a torch.export artifact, loaded and run
    on the card at two batch sizes: equal to the payload's predict of the
    same raw rows, launching the forward kernel once per layer a call."""
    from tpu_pipelines_torch.serving.saved_model import (
        export_saved_model,
        load_saved_model,
    )

    loaded = load_exported_model(flash_uri, device=DEVICE)
    t0 = time.perf_counter()
    out = export_saved_model(flash_uri, os.path.join(workdir, "artifact"),
                             {k: v[:4] for k, v in raw_rows.items()},
                             device=DEVICE)
    export_s = time.perf_counter() - t0
    run = load_saved_model(out)
    failures, gaps = [], {}
    for n in (3, 32):
        b = {k: v[:n] for k, v in raw_rows.items()}
        iface = loaded.host_preprocess(b)
        run(iface)  # first call: its own cuBLAS handles
        zero_counters()
        got = run(iface)
        launched = fa.launches
        gaps[n] = float(np.abs(got.float().cpu().numpy()
                               - loaded.predict(b)).max())
        if launched != N_LAYERS or gaps[n] > LOGIT_TOL:
            failures.append(f"artifact at batch {n}: {launched} launches, "
                            f"gap {gaps[n]:.3e}")
    size = os.path.getsize(os.path.join(out, "model.pt2"))
    print(f"serving_surface [{card}] torch.export artifact: exported in "
          f"{export_s:.1f} s ({size} bytes), loaded and run on the card at "
          f"batches 3 and 32: max |artifact - predict| {gaps} (tol "
          f"{LOGIT_TOL:g}), flash_fwd {N_LAYERS} launches a call", flush=True)
    return failures


def surface_federation(card, workdir, spool, history_root_env):
    """The BERT DAG rerun (SURFACE_STEPS steps: the Trainer and what follows
    it run, the rest cached) with the runner's TPP_METRICS_PORT federated
    over the spool the fleets published into, scraped once inside the
    Trainer; then its Trainer's metrics-history ring fills ``trace``'s
    train_telemetry once the run's own summary is cut from its log."""
    from tpu_pipelines_torch.examples import bert_pipeline
    from tpu_pipelines_torch.observability.metrics_history import MetricsHistory
    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.utils.module_loader import load_module

    base = os.path.join(workdir, "bert")
    root = os.path.join(base, "root")
    port = free_port()
    env = {"TPP_PIPELINE_HOME": base,
           "BERT_DATA_CSV": os.path.join(workdir, "reviews.csv"),
           "BERT_TRAIN_STEPS": str(SURFACE_STEPS), "BERT_TINY": "",
           "TPP_METRICS_PORT": str(port), **history_root_env}
    user = load_module(os.path.join(bert_pipeline.HERE, "bert_module.py"))
    real_loop, seen, results = user.train_loop, {}, []
    real_run = LocalDagRunner.run

    def loop(**kw):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            seen["scrape"] = r.read().decode()
        return real_loop(**kw)

    def run(self, *args, **kwargs):
        results.append(real_run(self, *args, **kwargs))
        return results[-1]

    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, env), \
            mock.patch.object(user, "train_loop", loop), \
            mock.patch.object(LocalDagRunner, "run", run):
        code, out = cli(["run", "--pipeline-module",
                         os.path.join(bert_pipeline.HERE, "bert_pipeline.py"),
                         "--device", DEVICE])
    run_s = time.perf_counter() - t0
    failures = []
    if code != 0:
        return [f"federation: the DAG rerun exited {code}: {out[-1500:]}"]
    result = results[-1]
    statuses = {k: v.status for k, v in result.nodes.items()}
    text = seen.get("scrape", "")
    fed_lines = [line for line in text.splitlines()
                 if line.startswith(("pipeline_nodes_running{",
                                     "serving_requests_total{"))]
    runner = [x for x in fed_lines if x.startswith("pipeline_nodes_running{")
              and 'host="' in x]
    fleet = [x for x in fed_lines if x.startswith("serving_requests_total{")
             and 'replica="' in x and 'host="' in x]
    sources = re.search(r"^federation_sources (\S+)$", text, re.M)
    print(f"serving_surface [{card}] federation: the BERT DAG rerun "
          f"({SURFACE_STEPS} steps) in {run_s:.1f} s, {statuses}; the "
          f"runner's :{port} scraped once inside the Trainer: "
          f"{len(runner)} runner and {len(fleet)} fleet series with "
          f"federation labels, federation_sources "
          f"{sources[1] if sources else None}; spool files "
          f"{sorted(os.listdir(spool))}", flush=True)
    if not runner or not fleet or not sources or float(sources[1]) < 2:
        failures.append("federation: the runner's scrape did not merge the "
                        "fleet's series")
    ring = MetricsHistory.for_pipeline_root(root)
    headline = ring.headline(result.run_id)
    events = os.path.join(root, ".runs", result.run_id, "trace", "events.jsonl")
    with open(events) as f:
        kept = [line for line in f if "train_telemetry_summary" not in line]
    with open(events, "w") as f:
        f.writelines(kept)
    code, out = cli(["trace", result.run_id, "--pipeline-root", root, "--json"])
    backfilled = json.loads(out).get("train_telemetry") if code == 0 else None
    print(f"serving_surface [{card}] metrics history: {len(ring.entries(result.run_id))} "
          f"snapshots of run {result.run_id}; headline {headline}; trace "
          f"(its summary cut from the log) backfilled train_telemetry "
          f"{'equal to the ring' if backfilled == headline else backfilled}",
          flush=True)
    if not headline or headline.get("steps") != SURFACE_STEPS \
            or backfilled != headline:
        failures.append(f"metrics history: headline {headline}, trace "
                        f"{backfilled}")
    return failures


def serving_surface_phase(seed, card, workdir, production_uri, surface_dir):
    """The rest of the serving surface (A8b) on the card: BERT-base from the
    bert_dag phase over REST and gRPC on raw and transformed examples with
    request tracing, T5-small's engine levers over gRPC, the InfraValidator
    over gRPC and on transformed examples, the torch.export artifact,
    metric federation and the metrics history.  Returns the flash_fwd and
    flash_decode launches of the served traffic."""
    from tpu_pipelines_torch.data import examples_io

    outputs = BERT_DAG_OUTPUTS
    trace_dir = os.path.join(surface_dir, "requests")
    spool = os.path.join(surface_dir, "spool")
    base = os.path.join(surface_dir, "bert")
    flash_uri = payload_view(production_uri, os.path.join(base, "1"),
                             attn_impl="flash")
    raw_rows = next(examples_io.iter_column_chunks(
        outputs["CsvExampleGen"]["examples"], "eval", rows=64))
    rows = next(examples_io.iter_column_chunks(
        outputs["Transform"]["transformed_examples"], "eval", rows=64))
    loaded = load_exported_model(flash_uri, device=DEVICE)
    rng = np.random.default_rng(seed + 19)
    raw_reqs = surface_requests(rng, raw_rows, SURFACE_REQUESTS)
    tr_reqs = surface_requests(rng, rows, SURFACE_REQUESTS)
    failures = []
    history_env = {"TPP_FEDERATION_DIR": spool, "TPP_METRICS_HISTORY": "1"}
    with mock.patch.dict(os.environ, history_env):
        f, p50_raw, fwd_raw, _ = surface_predicts(
            card, "raw", base, loaded.predict, raw_reqs, trace_dir)
        failures += f
        f, p50_tr, fwd_tr, _ = surface_predicts(
            card, "transformed", base, loaded.predict_transformed, tr_reqs,
            trace_dir, raw=False)
        failures += f
        f, decode = surface_generate(card, os.path.join(surface_dir, "t5"),
                                     trace_dir)
        failures += f
    failures += surface_trace_serve(trace_dir, 4 * SURFACE_REQUESTS + 2)
    failures += surface_infra(card, production_uri, outputs, workdir)
    failures += surface_export(card, flash_uri, raw_rows, workdir)
    failures += surface_federation(card, workdir, spool, history_env)
    print(f"serving_surface: REST vs gRPC p50 raw {p50_raw['rest']:.2f} / "
          f"{p50_raw['grpc']:.2f} ms, transformed {p50_tr['rest']:.2f} / "
          f"{p50_tr['grpc']:.2f} ms", flush=True)
    if failures:
        raise AssertionError(f"serving_surface: {failures}")
    return fwd_raw + fwd_tr, decode


# ------------------------------------------------------------- retrain DAG

# Reviews per span (each span split 2:1 into train.tfrecord and
# eval.tfrecord), the retrain's steps (cut from the bert_dag phase's 100),
# the Evaluator's value threshold, and the change threshold run 2 is held
# to: a retrained model must beat the production model's accuracy by this
# much to be blessed, which keeps run 1's model the baseline through the
# warm rerun.
RETRAIN_ROWS = 6000
RETRAIN_STEPS = 20
RETRAIN_MIN_ACCURACY = 0.5
RETRAIN_MIN_IMPROVEMENT = 0.5
# The pipeline module users would write for the retrain-against-production
# DAG (TFX's canonical wiring): it is written into the run's work directory
# and run through the CLI.  ``{pkg}`` is the package the components come
# from (the port here; its CPU parity test also fills in the reference).
RETRAIN_PIPELINE = """\\
import json
import os

from {pkg}.components import (
    Evaluator, ImportExampleGen, Importer, Pusher, Resolver, SchemaGen,
    StatisticsGen, Trainer, Transform,
)
from {pkg}.dsl import Cond, runtime_parameter
from {pkg}.dsl.pipeline import Pipeline


def create_pipeline():
    env = os.environ
    base = env["RETRAIN_HOME"]
    hp = json.loads(env["RETRAIN_HPARAMS"])
    gen = ImportExampleGen(input_path=env["RETRAIN_INPUT"])
    stats = StatisticsGen(examples=gen.outputs["examples"])
    schema = SchemaGen(statistics=stats.outputs["statistics"])
    transform = Transform(
        examples=gen.outputs["examples"], schema=schema.outputs["schema"],
        module_file=env["RETRAIN_PREPROCESSING"],
    )
    production = Importer(source_uri=env["RETRAIN_BASE_MODEL"],
                          artifact_type="Model")
    trainer = Trainer(
        examples=transform.outputs["transformed_examples"],
        transform_graph=transform.outputs["transform_graph"],
        base_model=production.outputs["result"],
        module_file=env["RETRAIN_MODULE"],
        train_steps=int(env["RETRAIN_STEPS"]),
        hyperparameters=hp,
    )
    baseline = Resolver(strategy="latest_blessed_model")
    evaluator = Evaluator(
        examples=transform.outputs["transformed_examples"],
        model=trainer.outputs["model"],
        baseline_model=baseline.outputs["model"],
        label_key="label", problem="multiclass",
        batch_size=int(hp["batch_size"]),
        value_thresholds={{"accuracy": {{
            "lower_bound": float(env["RETRAIN_MIN_ACCURACY"])}}}},
        change_thresholds={{"accuracy": {{
            "min_improvement": float(env["RETRAIN_MIN_IMPROVEMENT"])}}}},
    )
    with Cond(runtime_parameter("deploy", default=False) == True):  # noqa: E712
        pusher = Pusher(
            model=trainer.outputs["model"],
            blessing=evaluator.outputs["blessing"],
            statistics=stats.outputs["statistics"],
            push_destination=env["RETRAIN_PUSH"],
        )
    return Pipeline(
        "bert-retrain",
        [gen, stats, schema, transform, production, trainer, baseline,
         evaluator, pusher],
        pipeline_root=os.path.join(base, "root"),
        metadata_path=os.path.join(base, "metadata.sqlite"),
    )
"""


# The retrain's preprocessing: the twin's, with the production model's
# vocabulary read from a file instead of learned again, so the warm-started
# embeddings keep the token ids they were trained on (a vocabulary learned
# from another sample orders its words differently).
RETRAIN_PREPROCESSING = """\
MAX_LEN = 64


def preprocessing_fn(inputs, tft):
    ids = tft.tokenize(inputs["text"], max_len=MAX_LEN,
                       vocab_file={vocab_file!r})
    return {{
        "input_ids": ids,
        "attention_mask": tft.greater(ids, 0),
        "label": tft.cast(inputs["label"], "int32"),
    }}
"""


def production_vocabulary(payload_uri, path):
    """The tokenizer vocabulary of the payload's transform graph, one term
    a line, written to ``path``."""
    from tpu_pipelines_torch.trainer.export import TRANSFORM_DIR
    from tpu_pipelines_torch.transform.graph import TransformGraph

    graph = TransformGraph.load(os.path.join(payload_uri, TRANSFORM_DIR))
    vocab = graph.state[graph.outputs["input_ids"]]["vocab"]
    with open(path, "w") as f:
        f.write("\n".join(vocab) + "\n")
    return len(vocab)


def _varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(num, wire, body):
    """One protobuf field: a varint (wire 0), fixed32 (5) or
    length-delimited (2) ``body`` under field number ``num``."""
    key = _varint(num << 3 | wire)
    return key + _varint(len(body)) + body if wire == 2 else key + body


def _feature(value, packed):
    """One tf.train.Feature: a list of bytes as bytes_list, a float array
    as float_list, anything else as int64_list; repeated numbers packed
    or one field each."""
    import struct

    if isinstance(value, (list, tuple)) and value and isinstance(value[0], bytes):
        return _field(1, 2, b"".join(_field(1, 2, v) for v in value))
    arr = np.asarray(value)
    if arr.dtype.kind == "f":
        vals = arr.astype("<f4").ravel()
        body = (_field(1, 2, vals.tobytes()) if packed else b"".join(
            _field(1, 5, struct.pack("<f", v)) for v in vals))
        return _field(2, 2, body)
    vals = [int(v) for v in arr.ravel()]
    body = (_field(1, 2, b"".join(_varint(v) for v in vals)) if packed
            else b"".join(_field(1, 0, _varint(v)) for v in vals))
    return _field(3, 2, body)


def encode_example(features, packed=True):
    """``{name: list of bytes | float array | int array}`` as
    tf.train.Example bytes (Example.features = 1, Features.feature = 1, a
    map entry of key = 1 and value = 2)."""
    return _field(1, 2, b"".join(
        _field(1, 2, _field(1, 2, name.encode())
               + _field(2, 2, _feature(v, packed)))
        for name, v in features.items()))


def frame(payload, masked_crc=None):
    """One TFRecord: length, masked crc32c of the length, payload, masked
    crc32c of the payload (the port's crc unless ``masked_crc`` is
    given)."""
    import struct

    if masked_crc is None:
        from tpu_pipelines_torch.data.record_io import _masked_crc32c

        masked_crc = _masked_crc32c
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", masked_crc(length)) + payload
            + struct.pack("<I", masked_crc(payload)))


def write_tfrecord(path, payloads, masked_crc=None):
    with open(path, "wb") as f:
        for p in payloads:
            f.write(frame(p, masked_crc))


def write_span(d, seed, span, rows, lexicon=BERT_LEXICON):
    """``span``'s reviews as ``d/train.tfrecord`` and ``d/eval.tfrecord``
    (every third review to eval); returns the row counts."""
    os.makedirs(d)
    reviews = review_rows(seed, rows, part=span, lexicon=lexicon)
    splits = {"train": [], "eval": []}
    for i, (text, label) in enumerate(reviews):
        splits["eval" if i % 3 == 2 else "train"].append(
            encode_example({"text": [review_text(i, text, "she wrote").encode()],
                            "label": [label]}))
    for split, payloads in splits.items():
        write_tfrecord(os.path.join(d, f"{split}.tfrecord"), payloads)
    return {k: len(v) for k, v in splits.items()}


def retrain_env(base, data, base_model, push_dir, steps, hparams, module,
                preprocessing, min_accuracy=RETRAIN_MIN_ACCURACY):
    """The environment the retrain pipeline module reads."""
    return {"RETRAIN_HOME": base, "RETRAIN_INPUT": data,
            "RETRAIN_BASE_MODEL": base_model, "RETRAIN_PUSH": push_dir,
            "RETRAIN_STEPS": str(steps), "RETRAIN_HPARAMS": json.dumps(hparams),
            "RETRAIN_MODULE": module, "RETRAIN_PREPROCESSING": preprocessing,
            "RETRAIN_MIN_ACCURACY": str(min_accuracy),
            "RETRAIN_MIN_IMPROVEMENT": str(RETRAIN_MIN_IMPROVEMENT)}


def retrain_dag_phase(seed, card, workdir, production_uri):
    """The BERT-base retrain DAG on the card, through the port's CLI: spans
    of TFRecord reviews in, ImportExampleGen -> StatisticsGen -> SchemaGen
    -> Transform; an Importer of the production model (``production_uri``,
    the bert_dag phase's Trainer model) warm-starting the Trainer; a
    latest-blessed Resolver feeding the Evaluator's baseline; the Pusher
    inside ``Cond(deploy == True)``.  Run 1 (span 1, deploy) pushes; run 2
    (span 2 added, no deploy) evaluates against run 1's model and skips
    the push; a warm rerun of run 2 is all cache hits but the Resolver.
    Returns (each kernel's launches in run 2, the pushed payload)."""
    from tpu_pipelines_torch.data import examples_io
    from tpu_pipelines_torch.examples import bert_pipeline
    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.utils.module_loader import load_module

    base = os.path.join(workdir, "retrain")
    data = os.path.join(base, "data")
    push_dir = os.path.join(workdir, "pushed")
    t0 = time.perf_counter()
    rows1 = write_span(os.path.join(data, "span-1"), seed, 1, RETRAIN_ROWS)
    hp = dict(bert_pipeline.BERT_BASE)
    module_path = os.path.join(bert_pipeline.HERE, "bert_module.py")
    pipeline_module = os.path.join(base, "retrain_pipeline.py")
    with open(pipeline_module, "w") as f:
        f.write(RETRAIN_PIPELINE.format(pkg="tpu_pipelines_torch"))
    vocab_file = os.path.join(base, "vocab.txt")
    n_vocab = production_vocabulary(production_uri, vocab_file)
    preprocessing = os.path.join(base, "retrain_preprocessing.py")
    with open(preprocessing, "w") as f:
        f.write(RETRAIN_PREPROCESSING.format(vocab_file=vocab_file))
    print(f"retrain_dag data: span 1 {rows1} reviews as TFRecords of "
          f"tf.Example in {time.perf_counter() - t0:.2f} s; the production "
          f"model's vocabulary of {n_vocab} terms as the tokenizer's file",
          flush=True)
    env = retrain_env(base, os.path.join(data, "span-{SPAN}"), production_uri,
                      push_dir, RETRAIN_STEPS, hp, module_path, preprocessing)

    user = load_module(module_path)
    real_loop, real_run = user.train_loop, LocalDagRunner.run
    seen = {}
    results = []

    def loop(**kw):
        init = kw["init_params_fn"]

        def recording(*args, **kwargs):
            model = init(*args, **kwargs)
            seen["init"] = {k: v.detach().cpu().clone()
                            for k, v in model.state_dict().items()}
            return model

        losses = []

        def cb(step, metrics):
            losses.extend(v for k, v in metrics.items() if "loss" in k)
        model, result = real_loop(metrics_cb=cb, **{**kw, "init_params_fn":
                                                    recording})
        seen["result"], seen["losses"] = result, losses
        seen["after_trainer"] = counters()
        return model, result

    def run(self, *args, **kwargs):
        results.append(real_run(self, *args, **kwargs))
        return results[-1]

    def run_once(deploy):
        with mock.patch.dict(os.environ, env):
            code, out = cli(["run", "--pipeline-module", pipeline_module,
                             "--device", DEVICE, "--param",
                             f"deploy={'true' if deploy else 'false'}"])
        if code != 0:
            raise AssertionError(f"retrain_dag: run exited {code}: {out[-3000:]}")

    runs = []
    with mock.patch.object(LocalDagRunner, "run", run), \
            mock.patch.object(user, "train_loop", loop):
        for tag, deploy in (("run 1", True), ("run 2", False),
                            ("warm rerun", False)):
            if tag == "run 2":
                t0 = time.perf_counter()
                rows2 = write_span(os.path.join(data, "span-2"), seed, 2,
                                   RETRAIN_ROWS)
                print(f"retrain_dag data: span 2 {rows2} reviews in "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
            seen.clear()
            pushed_before = sorted(os.listdir(push_dir)) if os.path.isdir(
                push_dir) else []
            zero_counters()
            t0 = time.perf_counter()
            run_once(deploy)
            wall = time.perf_counter() - t0
            runs.append({"tag": tag, "result": results[-1], "wall": wall,
                         "launches": counters(), "seen": dict(seen),
                         "pushed_before": pushed_before,
                         "pushed_after": sorted(os.listdir(push_dir))
                         if os.path.isdir(push_dir) else []})
    r1, r2, r3 = runs
    props = {}
    for r in runs:
        props[r["tag"]] = node_props(base, r["result"])
        print(f"retrain_dag {r['tag']} [{card}]: {r['wall']:.1f} s: " + ", ".join(
            f"{k} {v.status} {v.wall_clock_s:.2f} s"
            for k, v in r["result"].nodes.items()), flush=True)

    # Run 1: the Resolver resolved nothing, the Evaluator blessed on its
    # value threshold alone, the Trainer started from the production
    # model's weights bit for bit, the Pusher pushed a payload carrying its
    # training statistics.
    s1 = {k: v.status for k, v in r1["result"].nodes.items()}
    want1 = {"ImportExampleGen": "COMPLETE", "StatisticsGen": "COMPLETE",
             "SchemaGen": "COMPLETE", "Transform": "COMPLETE",
             "Importer.Model": "COMPLETE", "Trainer": "COMPLETE",
             "Resolver": "COMPLETE", "Evaluator": "COMPLETE",
             "Pusher": "COMPLETE"}
    if s1 != want1:
        raise AssertionError(f"retrain_dag run 1: {s1} " + str(
            {k: v.error[-2000:] for k, v in r1["result"].nodes.items()
             if v.error}))
    p1 = props["run 1"]
    if (p1["Resolver"]["resolved_artifact_ids"] != []
            or not p1["Evaluator"]["blessed"]
            or p1["Evaluator"]["baseline_model_uri"] != ""):
        raise AssertionError(f"retrain_dag run 1: resolver "
                             f"{p1['Resolver']}, evaluator {p1['Evaluator']}")
    production = torch.load(os.path.join(production_uri, "checkpoint",
                                          "state_dict.pt"),
                            map_location="cpu", weights_only=True)
    init = r1["seen"]["init"]
    differ = [k for k in production
              if not torch.equal(production[k], init[k])]
    if sorted(init) != sorted(production) or differ:
        raise AssertionError(f"retrain_dag: the Trainer's first-step weights "
                             f"differ from the imported model at {differ[:8]}")
    pushed = [v for v in r1["pushed_after"] if v not in r1["pushed_before"]]
    if len(pushed) != 1 or not p1["Pusher"]["pushed"]:
        raise AssertionError(f"retrain_dag run 1: pushed {pushed}, "
                             f"{p1['Pusher']}")
    pushed_uri = os.path.join(push_dir, pushed[0])
    with open(os.path.join(pushed_uri, "model_spec.json")) as f:
        stats_uri = json.load(f).get("training_statistics_uri", "")
    stats_art = r1["result"].outputs_of("StatisticsGen", "statistics")[0]
    if stats_uri != stats_art.uri:
        raise AssertionError(f"retrain_dag: pushed spec statistics "
                             f"{stats_uri!r}, StatisticsGen {stats_art.uri!r}")
    model1 = r1["result"].outputs_of("Trainer", "model")[0]

    # Run 2: span 2 re-ingested, the Resolver re-emitted run 1's model (its
    # artifact id), the Evaluator evaluated candidate and baseline, the
    # Pusher condition-skipped with the push directory unchanged.
    s2 = {k: v.status for k, v in r2["result"].nodes.items()}
    want2 = {**want1, "Importer.Model": "CACHED", "Pusher": "COND_SKIPPED"}
    p2 = props["run 2"]
    resolved = r2["result"].outputs_of("Resolver", "model")
    gen2 = r2["result"].outputs_of("ImportExampleGen", "examples")[0]
    if (s2 != want2 or not r2["result"].succeeded
            or [a.id for a in resolved] != [model1.id]
            or p2["Resolver"]["resolved_artifact_ids"] != [model1.id]
            or p2["Evaluator"]["baseline_model_uri"] != model1.uri
            or gen2.properties.get("span") != 2
            or r2["pushed_after"] != r2["pushed_before"]):
        raise AssertionError(
            f"retrain_dag run 2: {s2}, resolved {[a.id for a in resolved]} "
            f"(run 1's model {model1.id}), evaluator {p2['Evaluator']}, "
            f"span {gen2.properties.get('span')}, pushed "
            f"{r2['pushed_before']} -> {r2['pushed_after']}")
    # The warm rerun: every executor node a cache hit, the Resolver run
    # again (never cached) re-emitting the same artifact, the skip replayed.
    s3 = {k: v.status for k, v in r3["result"].nodes.items()}
    want3 = {k: "CACHED" for k in want1}
    want3.update({"Resolver": "COMPLETE", "Pusher": "COND_SKIPPED"})
    if (s3 != want3 or [a.id for a in r3["result"].outputs_of(
            "Resolver", "model")] != [model1.id]
            or any(r3["launches"].values())):
        raise AssertionError(f"retrain_dag warm rerun: {s3}, launches "
                             f"{r3['launches']}")

    # Launches from inside the runner: run 1 one Evaluator pass, run 2 two
    # (candidate and baseline); each run's Trainer steps.
    layers = DEFAULT_HPARAMS["n_layers"]
    batch = hp["batch_size"]
    impl = tfm.choose_attn_impl(batch, DEFAULT_HPARAMS["n_heads"],
                                PIPELINE_LEN, PIPELINE_LEN, 2,
                                torch.device(DEVICE))
    flash = impl == "flash"
    for r, passes in ((r1, 1), (r2, 2)):
        uri = r["result"].outputs_of("Transform", "transformed_examples")[0].uri
        n_eval = examples_io.num_rows(uri, "eval")
        steps = layers * RETRAIN_STEPS * flash
        trainer_fwd = steps + layers * (n_eval // batch) * flash
        want = {"launches": trainer_fwd + passes * layers * -(-n_eval // batch)
                * flash, "dvec_launches": steps, "dq_launches": steps,
                "dkv_launches": steps, "decode_launches": 0}
        if r["launches"] != want or r["seen"]["after_trainer"] != {
                **want, "launches": trainer_fwd}:
            raise AssertionError(
                f"retrain_dag {r['tag']}: launches {r['launches']} (after "
                f"the Trainer {r['seen']['after_trainer']}), expected {want} "
                f"for auto = {impl}")
        res = r["seen"]["result"]
        if (res.steps_completed != RETRAIN_STEPS
                or not np.isfinite(r["seen"]["losses"]).all()
                or res.compiles_after_warm != 0):
            raise AssertionError(f"retrain_dag {r['tag']}: trainer {res}")
        r["n_eval"] = n_eval
    ig = p1["ImportExampleGen"]
    print(f"retrain_dag ImportExampleGen [{card}]: span 1 "
          f"{ig['num_examples']} rows at {ig['ingest_rows_per_sec']} rows/s "
          f"with every record's crc verified; span 2 "
          f"{p2['ImportExampleGen']['num_examples']} rows at "
          f"{p2['ImportExampleGen']['ingest_rows_per_sec']} rows/s", flush=True)
    for r, passes in ((r1, 1), (r2, 2)):
        ev = props[r["tag"]]["Evaluator"]
        res = r["seen"]["result"]
        print(f"retrain_dag {r['tag']} [{card}]: Trainer warm-started from the "
              f"production model, {res.steps_completed} steps at batch {batch} "
              f"x {PIPELINE_LEN}, losses {r['seen']['losses'][0]:.4f} -> "
              f"{r['seen']['losses'][-1]:.4f}, {res.examples_per_sec:.1f} "
              f"examples/s over the run; Evaluator {passes} pass(es) over "
              f"{r['n_eval']} eval rows in {r['result'].nodes['Evaluator'].wall_clock_s:.2f} s: "
              f"accuracy {ev['overall_accuracy']:.4f}, blessed {ev['blessed']}"
              + (f" ({'; '.join(ev['not_blessed_reasons'])})"
                 if ev["not_blessed_reasons"] else "")
              + f"; launches {r['launches']}", flush=True)
    print(f"retrain_dag: run 1 resolved nothing (bootstrap, value threshold "
          f"only), the Trainer's first-step weights == the imported model's "
          f"bit for bit ({len(init)} tensors), pushed version {pushed[0]} with "
          f"training_statistics_uri; run 2 resolved run 1's model (artifact "
          f"{model1.id}), baseline evaluated, Pusher COND_SKIPPED, push "
          f"directory unchanged; warm rerun {r3['wall']:.2f} s: "
          f"{sum(v == 'CACHED' for v in s3.values())} CACHED, Resolver "
          f"COMPLETE, Pusher COND_SKIPPED, no kernel launched", flush=True)

    # The Evaluator's logits against dense attention on run 2's candidate,
    # a shifted-mask control above the tolerance.
    from tpu_pipelines_torch.data.input_pipeline import BatchIterator, InputConfig

    model2 = r2["result"].outputs_of("Trainer", "model")[0].uri
    examples2 = r2["result"].outputs_of("Transform", "transformed_examples")[0].uri
    flash_model = load_exported_model(model2, device=DEVICE)
    dense = load_exported_model(payload_view(
        model2, os.path.join(workdir, "retrain_dense"), attn_impl="dense"),
        device=DEVICE)
    gap = control = 0.0
    for i, b in enumerate(BatchIterator(examples2, "eval", InputConfig(
            batch_size=batch, shuffle=False, num_epochs=1,
            drop_remainder=False))):
        if i == 2:
            break
        want_logits = dense.predict_transformed(b)
        gap = max(gap, float(np.abs(flash_model.predict_transformed(b)
                                    - want_logits).max()))
        shifted = {**b, "attention_mask": np.roll(b["attention_mask"], 1, 1)}
        control = max(control, float(np.abs(
            flash_model.predict_transformed(shifted) - want_logits).max()))
    del flash_model, dense
    print(f"retrain_dag: run 2's candidate vs dense attention on two eval "
          f"batches: max |logit gap| {gap:.3e} (tol {LOGIT_TOL:g}); "
          f"shifted-mask control {control:.3e} (must exceed)", flush=True)
    if gap > LOGIT_TOL or control <= LOGIT_TOL:
        raise AssertionError("retrain_dag: flash logits vs dense attention")
    return by_record(r2["launches"]), pushed_uri


# ---------------------------------------------------------- fleet guard

# The post-deploy guards on the BERT fleet: the SLO monitor's interval,
# drift windows of GUARD_WINDOW_S over every request (sample rate 1), and
# the post-swap probation window (TPP_SWAP_PROBATION_S) the rollback must
# land in.  Traffic comes from GUARD_THREADS client threads.  The monitor
# judges latency too (the share of requests over the 50 ms SLO), and a
# latency breach inside the probation would roll the swap back before the
# fault does: the phase prints that burn at the swap and at the rollback
# beside the lines it pages at, and fails unless the one rollback is the
# 5xx burn's.  The sampler's cost is read over GUARD_TPUT_ROUNDS rounds of
# GUARD_REQUESTS requests, the sampler on and off in turn (on, off, off,
# on, ...).
GUARD_MONITOR_S = 0.5
GUARD_WINDOW_S = 2.0
GUARD_SAMPLE = 1.0
GUARD_PROBATION_S = 10.0
GUARD_REQUESTS = 64
GUARD_THREADS = 4
GUARD_TPUT_ROUNDS = 8
# Distinct reviews in the shifted (skewed) window: a flood of a few texts
# from the upper half of the lexicon.
GUARD_CAMPAIGN = 2


def review_requests(rng, reviews, n):
    """``n`` :predict bodies of 1-2 rows each, drawn from ``reviews``."""
    out = []
    for _ in range(n):
        picks = rng.integers(0, len(reviews), int(rng.integers(1, 3)))
        out.append({"instances": [{"text": reviews[i][0],
                                   "label": reviews[i][1]} for i in picks]})
    return out


def request_rows(requests):
    rows = [r for req in requests for r in req["instances"]]
    return {"text": np.asarray([r["text"] for r in rows], dtype=object),
            "label": np.asarray([r["label"] for r in rows], np.int64)}


def fleet_guard_phase(seed, card, workdir, production_uri, pushed_uri):
    """The BERT fleet of the fleet phase with the post-deploy guards on:
    boots on the production model (the bert_dag phase's, the retrain's
    base), hot-swaps to the retrain's pushed payload under load, scores
    drift windows against that payload's training statistics (a skewed
    window breaches, a control window stays quiet, the CLI's ``drift``
    reads both), rolls the new version back on a DEVICE_ERROR burst inside
    its probation window (quarantined, 409 on :reload, re-admitted by
    clear_quarantine), and leaves a version whose probation expired alone.
    Returns the flash_fwd launches of the boot traffic."""
    from tpu_pipelines_torch.testing import faults
    from tpu_pipelines_torch.trainer.export import _to_numpy, on_device

    base = os.path.join(workdir, "fleet_guard")
    payload_copy(production_uri, os.path.join(base, "1"))
    rng = np.random.default_rng(seed + 13)
    unseen = [(review_text(i, t, "she wrote"), label) for i, (t, label) in
              enumerate(review_rows(seed, 512, part=3))]
    lexicon = made_up_words(np.random.default_rng(seed), BERT_LEXICON)
    upper = np.asarray(lexicon[40:][(BERT_LEXICON - 40) // 2:])
    campaign = [(" ".join(rng.choice(upper, 24)), int(rng.integers(0, 2)))
                for _ in range(GUARD_CAMPAIGN)]
    boot_reqs = review_requests(rng, unseen, GUARD_REQUESTS)
    swap_reqs = review_requests(rng, unseen, GUARD_REQUESTS)
    control_reqs = review_requests(rng, unseen, GUARD_REQUESTS)
    shifted_reqs = review_requests(rng, campaign, GUARD_REQUESTS)
    after_reqs = review_requests(rng, unseen, GUARD_REQUESTS // 2)
    tput_reqs = review_requests(rng, unseen, GUARD_REQUESTS)

    graph = torch.cuda.CUDAGraph
    real_capture = graph.capture_begin
    captures = [0]

    def counted_capture(self, *args, **kwargs):
        captures[0] += 1
        return real_capture(self, *args, **kwargs)

    with mock.patch.dict(os.environ, {"TPP_SWAP_PROBATION_S":
                                      str(GUARD_PROBATION_S)}):
        server = ModelServer(
            "bert", base, replicas=FLEET_REPLICAS, max_versions=2,
            slo_p99_ms=FLEET_SLO_MS, max_batch_size=FLEET_BATCH,
            supervisor_interval_s=FLEET_SUPERVISOR_S,
            slo_monitor_interval_s=GUARD_MONITOR_S,
            monitor_sample_rate=GUARD_SAMPLE, monitor_window_s=GUARD_WINDOW_S,
            device="cuda")
    fleet = server._fleet
    replicas = fleet.pool.replicas
    windows, breaches = [], []
    fleet.sampler.on_window = windows.append

    def on_breach(breach):
        breaches.append((time.monotonic(), breach, fleet.on_slo_breach(breach)))

    server.slo_monitor.on_breach = on_breach
    # Every evaluation the monitor makes, kept to read the latency burn.
    evaluations = []
    evaluate = server.slo_monitor.evaluate

    def recorded(now=None):
        result = evaluate(now)
        evaluations.append((time.monotonic(), result))
        return result

    server.slo_monitor.evaluate = recorded
    seen = {}
    try:
        with mock.patch.object(graph, "capture_begin", counted_capture):
            url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/bert"

            def clients(reqs):
                return run_clients(f"{url}:predict", reqs, n_procs=1,
                                   threads=GUARD_THREADS)

            def flushed(phase_rows):
                """Every sampled row so far is in a closed window (the
                sampler's queue and open window empty; rows counted as the
                batcher padded them, so at least the rows sent)."""
                sampler = fleet.sampler
                wait_for(lambda: sampler._queue.qsize() == 0
                         and not any(n for _, _, n in sampler._buckets.values())
                         and sum(w.sampled for w in windows) >= phase_rows,
                         4 * GUARD_WINDOW_S + 10, "the drift windows")

            # 1. Boot on the production model: its first batch captures
            # its buckets; the traffic's launches are counted.
            warm, _ = clients(boot_reqs[:1])
            zero_counters()
            batches0 = sum(r.batcher.batches_run for r in replicas)
            seen["boot"], boot_s = clients(boot_reqs[1:])
            seen["boot_launches"] = fa.launches
            seen["boot_batches"] = (sum(r.batcher.batches_run for r in replicas)
                                    - batches0)
            v1 = fleet.active_loaded()
            warm1 = dict(fleet.last_warm or {})
            sampled = sum(len(req["instances"]) for req in boot_reqs)
            flushed(sampled)

            # 2. The retrain's pushed payload, hot-swapped under load.
            payload_copy(pushed_uri, os.path.join(base, "2"))
            swap = {}

            def hammer():
                swap["results"], _ = clients(swap_reqs)

            clients_thread = threading.Thread(target=hammer)
            served0 = sum(r.latency.count for r in replicas)
            clients_thread.start()
            wait_for(lambda: sum(r.latency.count for r in replicas)
                     >= served0 + 8, 120, "the swap's traffic")
            swap["reload"] = post_code(f"{url}:reload")
            clients_thread.join()
            swap["done"] = time.monotonic()
            sampled += sum(len(req["instances"]) for req in swap_reqs)
            flushed(sampled)
            v2 = fleet.active_loaded()
            warm2 = dict(fleet.last_warm)
            swap_mono = fleet.versions.last_swap()["mono"]

            # 3. Drift against the pushed payload's training statistics: a
            # control window of unseen reviews, then the campaign.
            n_windows = len(windows)
            seen["control"], _ = clients(control_reqs)
            sampled += sum(len(req["instances"]) for req in control_reqs)
            flushed(sampled)
            control_windows = windows[n_windows:]
            n_windows = len(windows)
            seen["shifted"], _ = clients(shifted_reqs)
            sampled += sum(len(req["instances"]) for req in shifted_reqs)
            flushed(sampled)
            shifted_windows = windows[n_windows:]
            drift_code, drift_json = cli(["drift", "--url", url, "--json"])
            _, drift_text = cli(["drift", "--url", url])

            # 4. DEVICE_ERROR on every replica while version 2 serves, until
            # the monitor's breach rolls back.
            captures0 = captures[0]
            fault_codes, first_bad = [], []
            plan = faults.FaultPlan({faults.REPLICA_KEY: faults.NodeFault(
                faults.DEVICE_ERROR, times=10 ** 6)})
            stop = threading.Event()

            def faulty_client(i):
                body = after_reqs[i % len(after_reqs)]
                while not stop.is_set():
                    code, _ = post_code(f"{url}:predict", body)
                    fault_codes.append(code)
                    if code >= 500 and not first_bad:
                        first_bad.append(time.monotonic())

            with plan.activate():
                threads = [threading.Thread(target=faulty_client, args=(i,))
                           for i in range(GUARD_THREADS)]
                for t in threads:
                    t.start()
                try:
                    wait_for(lambda: fleet.active_version == "1", 60,
                             "the rollback")
                finally:
                    stop.set()
                    for t in threads:
                        t.join()
            rollback = fleet.versions.last_swap()
            health = server.health()
            rollbacks = server.metrics.get("serving_auto_rollbacks_total").get()
            refused = post_code(f"{url}:reload")
            wait_for(lambda: all(fleet.supervisor.state(r) == "healthy"
                                 for r in replicas), 30, "the replicas' health")
            seen["after"], _ = clients(after_reqs)
            rollback_captures = captures[0] - captures0
            after_warm = (v1.aot.compiles_after_warm, server.metrics.get(
                "serving_aot_compiles_after_warm_total").get())

            # 5. Re-admitted by clear_quarantine; its probation then runs
            # out while the checks below run.
            cleared = fleet.clear_quarantine()
            readmit = post_code(f"{url}:reload")
            readmit_mono = fleet.versions.last_swap()["mono"]
            readmit_captures = captures[0] - captures0 - rollback_captures
            t0 = time.perf_counter()

            # Version 1's buckets replayed after the rollback == eager.
            rows = request_rows(boot_reqs + swap_reqs)
            buckets = warm1.get("buckets", [])
            unequal = [b for b in buckets if not np.array_equal(
                v1.predict({k: v[:b] for k, v in rows.items()}),
                eager(v1, v1.host_preprocess(
                    {k: v[:b] for k, v in rows.items()})))]
            # While the re-admitting swap's probation runs out: replies
            # against dense attention, each traffic against the version
            # that served it (the swap's against either).
            dense = {}
            for v, uri in (("1", production_uri), ("2", pushed_uri)):
                dense[v] = load_exported_model(payload_view(
                    uri, os.path.join(workdir, f"guard_dense_{v}"),
                    attn_impl="dense"), device="cuda")

            def dense_gap(results, reqs, versions):
                """Max over rows of the row's logit gap to the nearest of the
                versions that may have served it."""
                served = np.concatenate([
                    np.asarray(reply["predictions"], np.float32)
                    for _, reply, _ in results])
                rows = request_rows(reqs)
                per_version = [np.abs(served - np.concatenate([
                    dense[v].predict({k: x[i:i + 32] for k, x in rows.items()})
                    for i in range(0, len(rows["text"]), 32)])).max(axis=1)
                    for v in versions]
                return float(np.min(per_version, axis=0).max())

            gaps = {}
            for name, results, reqs, versions in (
                    ("boot", seen["boot"], boot_reqs[1:], "1"),
                    ("swap", swap["results"], swap_reqs, "12"),
                    ("control", seen["control"], control_reqs, "2"),
                    ("shifted", seen["shifted"], shifted_reqs, "2"),
                    ("after rollback", seen["after"], after_reqs, "1")):
                codes = sorted({c for c, _, _ in results})
                if codes != [200]:
                    raise AssertionError(
                        f"fleet_guard {name}: replies {codes}")
                gaps[name] = dense_gap(results, reqs, versions)
            # Control: version 1's forward fed the mask of the next row.
            def forward(loaded, feats):
                with torch.inference_mode():
                    return _to_numpy(loaded.forward_step(
                        loaded.params, on_device(feats, loaded.device)))

            host = v1.transform.apply_host({k: v[:32] for k, v in request_rows(
                boot_reqs).items()})
            feats = {k: host[k] for k in ("input_ids", "attention_mask")}
            shifted = {**feats, "attention_mask": np.roll(
                feats["attention_mask"], 1, axis=0)}
            control = float(np.abs(forward(v1, shifted)
                                   - forward(dense["1"], feats)).max())
            del dense
            wait_s = readmit_mono + GUARD_PROBATION_S + 0.5 - time.monotonic()
            if wait_s > 0:
                time.sleep(wait_s)
            expired = fleet.on_slo_breach({"slo": "errors_5xx",
                                           "trigger": "fast"})
            expired_active = fleet.active_version
            checks_s = time.perf_counter() - t0

            # The sampler's cost, after that probation ran out: the rounds'
            # load must not page latency inside a probation (on a slow host
            # it did, and rolled the re-admitted version back).
            t1 = time.perf_counter()
            n_tput = sum(len(req["instances"]) for req in tput_reqs)
            sampler, tput = fleet.sampler, {"on": [], "off": []}
            for i in range(GUARD_TPUT_ROUNDS):
                state = "on" if i % 4 in (0, 3) else "off"
                fleet.sampler = sampler if state == "on" else None
                _, round_s = clients(tput_reqs)
                tput[state].append(n_tput / round_s)
            fleet.sampler = sampler
            tput_s = time.perf_counter() - t1
    finally:
        server.stop()

    def skew_alerts(ws):
        return [s for w in ws if w.version == "2"
                and w.sampled >= fleet.sampler.min_samples
                for s in w.alerts if s.kind.startswith("skew")]

    def latency_burn(evaluation):
        """The latency_p99 burn per window (seconds) in ``evaluation``."""
        return {int(w): v["burn"].get("latency_p99")
                for w, v in evaluation["windows"].items()}

    monitor = server.slo_monitor
    at_swap = [r for t, r in evaluations if t <= swap["done"]]
    at_rollback = [r for t, r in evaluations if t >= rollback["mono"]]
    peak = max((b or 0.0 for t, r in evaluations if t <= rollback["mono"]
                for b in latency_burn(r).values()), default=0.0)
    report = json.loads(drift_json)
    lat_ms = np.array([t for _, _, t in seen["boot"]]) * 1e3
    fired = [(round(t - swap_mono, 3), b["slo"], did) for t, b, did in breaches]
    rolled = [(t, b) for t, b, did in breaches if did]
    print(f"fleet_guard [{card}]: BERT-base behind ModelServer(replicas="
          f"{FLEET_REPLICAS}, max_versions=2, slo_p99_ms={FLEET_SLO_MS:g}, "
          f"slo_monitor_interval_s={GUARD_MONITOR_S}, monitor_sample_rate="
          f"{GUARD_SAMPLE}, monitor_window_s={GUARD_WINDOW_S}), "
          f"TPP_SWAP_PROBATION_S={GUARD_PROBATION_S:g}: boot on the production "
          f"model, {len(boot_reqs) - 1} requests in {seen['boot_batches']} "
          f"device batches, {boot_s:.2f} s, p50 {np.percentile(lat_ms, 50):.2f} "
          f"ms, slowest {lat_ms.max():.2f} ms, {int((lat_ms > FLEET_SLO_MS).sum())} "
          f"of {len(lat_ms)} over the {FLEET_SLO_MS:g} ms SLO, flash_fwd launches "
          f"{seen['boot_launches']} ({N_LAYERS} x batches expected); version 1 "
          f"captured {warm1.get('compiled')} graphs on its first batch",
          flush=True)
    print(f"fleet_guard: hot swap to the retrain's payload under load: reload "
          f"answered {swap['reload'][0]}, {warm2.get('compiled')} graphs "
          f"captured at its gate in {warm2.get('seconds', 0.0):.3f} s; max "
          f"|fleet - dense| logit per traffic {gaps} (tol {LOGIT_TOL:g}); "
          f"mask-of-the-next-row control {control:.3e} (must exceed)",
          flush=True)
    for name, ws in (("control", control_windows), ("shifted", shifted_windows)):
        for w in ws:
            worst = sorted(w.scores, key=lambda s: -s.distance)[:3]
            print(f"fleet_guard drift {name} window {w.index} (version "
                  f"{w.version}, {w.sampled} rows, baseline {w.baseline_uri}): "
                  + ", ".join(f"{s.feature} {s.kind} {s.distance:.4f}"
                              for s in worst)
                  + f"; alerts {[s.kind for s in w.alerts]}", flush=True)
    print(f"fleet_guard `python -m tpu_pipelines_torch drift` (exit "
          f"{drift_code}): max skew {report['max_skew']:.4f}, alerts "
          f"{report['alerts_total']:g}, sampled {report['sampled_total']:g}, "
          f"windows {report['windows_total']:g}, coverage "
          f"{report['coverage_ratio']}\n" + drift_text.strip(), flush=True)
    print(f"fleet_guard rollback [{card}]: DEVICE_ERROR on every replica "
          f"({len(fault_codes)} replies {sorted(set(fault_codes))}); breaches "
          f"(seconds after the swap, slo, rolled back): {fired}; rolled back "
          f"{rollback['version']} <- {rollback['prior']} "
          f"{rollback['mono'] - swap_mono:.3f} s after the swap, "
          f"{rollback['mono'] - first_bad[0]:.3f} s after the first bad reply; "
          f"serving_auto_rollbacks_total {rollbacks:g}; latency_p99 burn per "
          f"window (s) at the swap's last evaluation "
          f"{latency_burn(at_swap[-1]) if at_swap else None}, at the "
          f"rollback's {latency_burn(at_rollback[0]) if at_rollback else None}"
          f", peak before the rollback {peak:.3f} (pages at "
          f"{monitor.fast_threshold:g} in every window of "
          f"{[int(w) for w in monitor.fast_windows_s]} or "
          f"{monitor.slow_threshold:g} in the others); :reload of the "
          f"quarantined version answered {refused[0]}; health quarantined "
          f"{health['fleet'].get('quarantined_versions')}; captures during "
          f"the rollback {rollback_captures}, compiles after warm "
          f"{after_warm}; version 1's buckets {buckets} replay == eager "
          f"(unequal: {unequal}); after the rollback "
          f"{len(seen['after'])} requests all 200", flush=True)
    on, off = np.median(tput["on"]), np.median(tput["off"])
    blocks = [sum(tput["on"][2 * b:2 * b + 2]) / sum(tput["off"][2 * b:2 * b + 2])
              for b in range(GUARD_TPUT_ROUNDS // 4)]
    print(f"fleet_guard [{card}]: clear_quarantine {cleared}, :reload "
          f"{readmit[0]} (re-admitted, {readmit_captures} captures); served "
          f"examples/s over {GUARD_TPUT_ROUNDS} rounds of {len(tput_reqs)} "
          f"requests ({n_tput} rows) in {tput_s:.1f} s, the sampler on and "
          f"off in turn: on median {on:.1f} (rounds "
          f"{[round(x, 1) for x in tput['on']]}), off median {off:.1f} "
          f"(rounds {[round(x, 1) for x in tput['off']]}), on/off "
          f"{on / off:.3f}, per on-off-off-on block "
          f"{[round(x, 3) for x in blocks]} (context, not a gain); a breach "
          f"{GUARD_PROBATION_S:g}+ s after the re-admitting "
          f"swap rolled back {expired}, active {expired_active} (checks and "
          f"wait {checks_s:.1f} s)", flush=True)
    if warm1.get("compiled") != len(buckets) or not buckets:
        raise AssertionError(f"fleet_guard: version 1's warm-up {warm1}")
    if seen["boot_launches"] != N_LAYERS * seen["boot_batches"]:
        raise AssertionError(f"fleet_guard: {seen['boot_launches']} launches "
                             f"for {seen['boot_batches']} batches")
    if swap["reload"][0] != 200 or warm2.get("compiled") != len(buckets):
        raise AssertionError(f"fleet_guard: swap {swap['reload']}, {warm2}")
    if max(gaps.values()) > LOGIT_TOL or control <= LOGIT_TOL:
        raise AssertionError(f"fleet_guard: dense gaps {gaps}, control {control}")
    if (not control_windows or skew_alerts(control_windows)
            or not skew_alerts(shifted_windows)):
        raise AssertionError("fleet_guard: the control window alerted or the "
                             "shifted window did not")
    if drift_code != 0 or report["alerts_total"] < 1 or (
            report["max_skew"] <= DEFAULT_DRIFT_THRESHOLD):
        raise AssertionError(f"fleet_guard: drift report {report}")
    if (len(rolled) != 1 or rolled[0][1]["slo"] != "errors_5xx"
            or not first_bad or rollback["version"] != "1"
            or not rollback["rollback"]
            or rollback["mono"] - swap_mono > GUARD_PROBATION_S):
        raise AssertionError(f"fleet_guard: rollback {rollback}, breaches "
                             f"{fired}")
    if (rollbacks != 1 or refused[0] != 409
            or health["fleet"].get("quarantined_versions") != ["2"]):
        raise AssertionError(f"fleet_guard: rollbacks {rollbacks}, reload "
                             f"{refused}, health {health['fleet']}")
    if rollback_captures or readmit_captures or after_warm != (0, 0) or unequal:
        raise AssertionError(
            f"fleet_guard: {rollback_captures} captures at the rollback, "
            f"{readmit_captures} at the re-admission, compiles after warm "
            f"{after_warm}, unequal buckets {unequal}")
    if cleared != ["2"] or readmit[0] != 200 or expired or expired_active != "2":
        raise AssertionError(f"fleet_guard: re-admission {cleared} "
                             f"{readmit}, expired probation rolled back "
                             f"{expired} ({expired_active})")
    return seen["boot_launches"]


# ------------------------------------------------------- continuous (A23)

# The continuous controller over TFRecord spans of CONT_ROWS reviews each
# (cut from the retrain's 6000 for time): a window of CONT_WINDOW spans,
# BERT-base retrained CONT_STEPS steps from the production model, pushed
# into the guarded fleet (GUARD_* monitor, CONT_PROBATION_S probation).  A
# retrain is blessed at accuracy >= RETRAIN_MIN_ACCURACY and no more than
# CONT_MAX_DROP below its baseline's.
CONT_ROWS = 4000
CONT_STEPS = 20
CONT_WINDOW = 2
CONT_MAX_DROP = 0.05
CONT_PROBATION_S = 10.0
CONT_NODE_TIMEOUT_S = 900.0
# The continuous deployment users would write (``create_continuous``), its
# settings read from the environment ``continuous_env`` makes: a per-span
# ingest pipeline and a window pipeline sharing one store.  The window's
# Transform runs at window level, so the tokenizer (the production model's
# vocabulary file) sees the whole window.
CONTINUOUS_PIPELINE = """\\
import json
import os

from tpu_pipelines_torch.components import (
    Evaluator, ImportExampleGen, Importer, Pusher, RollingWindowResolver,
    SchemaGen, StatisticsGen, Trainer, Transform,
)
from tpu_pipelines_torch.continuous import (
    ContinuousConfig, SpanWindow, WindowStatisticsMerger,
)
from tpu_pipelines_torch.dsl.pipeline import Pipeline

ENV = os.environ


def _pipeline(name, components):
    return Pipeline(
        name, components,
        pipeline_root=os.path.join(ENV["CONT_HOME"], name),
        metadata_path=os.path.join(ENV["CONT_HOME"], "metadata.sqlite"),
        node_timeout_s=float(ENV["CONT_NODE_TIMEOUT_S"]),
    )


def span_pipeline(span, version):
    gen = ImportExampleGen(input_path=ENV["CONT_INPUT"], span=span,
                           version=version)
    stats = StatisticsGen(examples=gen.outputs["examples"],
                          save_accumulators=True)
    return _pipeline("bert-spans", [gen, stats])


def window_pipeline():
    hp = json.loads(ENV["CONT_HPARAMS"])
    win = RollingWindowResolver(
        window_spans=int(ENV["CONT_WINDOW"]), source_pipeline="bert-spans",
        examples_producer="ImportExampleGen",
        statistics_producer="StatisticsGen",
    )
    window = SpanWindow(examples=win.outputs["examples"])
    merged = WindowStatisticsMerger(statistics=win.outputs["statistics"])
    schema = SchemaGen(statistics=merged.outputs["statistics"])
    transform = Transform(
        examples=window.outputs["window"], schema=schema.outputs["schema"],
        module_file=ENV["CONT_PREPROCESSING"],
    )
    production = Importer(source_uri=ENV["CONT_BASE_MODEL"],
                          artifact_type="Model")
    trainer = Trainer(
        examples=transform.outputs["transformed_examples"],
        transform_graph=transform.outputs["transform_graph"],
        base_model=production.outputs["result"],
        module_file=ENV["CONT_MODULE"],
        train_steps=int(ENV["CONT_STEPS"]),
        hyperparameters=hp,
    )
    evaluator = Evaluator(
        examples=transform.outputs["transformed_examples"],
        model=trainer.outputs["model"],
        baseline_model=win.outputs["model"],
        label_key="label", problem="multiclass",
        batch_size=int(hp["batch_size"]),
        value_thresholds={"accuracy": {
            "lower_bound": float(ENV["CONT_MIN_ACCURACY"])}},
        change_thresholds={"accuracy": {
            "min_improvement": -float(ENV["CONT_MAX_DROP"])}},
    )
    pusher = Pusher(
        model=trainer.outputs["model"],
        blessing=evaluator.outputs["blessing"],
        statistics=merged.outputs["statistics"],
        push_destination=ENV["CONT_PUSH"],
        serving_push_url=ENV["CONT_URL"],
    )
    return _pipeline("bert-window", [
        win, window, merged, schema, transform, production, trainer,
        evaluator, pusher])


def create_continuous():
    return ContinuousConfig(
        input_pattern=ENV["CONT_INPUT"],
        make_span_pipeline=span_pipeline,
        make_window_pipeline=window_pipeline,
        poll_interval_s=1.0,
        serving_url=ENV["CONT_URL"],
        probation_watch_s=float(ENV["CONT_PROBATION_S"]),
        probation_poll_s=0.1,
        state_dir=os.path.join(ENV["CONT_HOME"], "state"),
        device=ENV["CONT_DEVICE"],
    )
"""


def continuous_env(base, push_dir, url, production_uri, hparams, module,
                   preprocessing):
    """The environment the continuous module reads."""
    return {"CONT_HOME": base,
            "CONT_INPUT": os.path.join(base, "data", "span-{SPAN}",
                                       "v-{VERSION}"),
            "CONT_BASE_MODEL": production_uri, "CONT_PUSH": push_dir,
            "CONT_URL": url, "CONT_STEPS": str(CONT_STEPS),
            "CONT_HPARAMS": json.dumps(hparams), "CONT_MODULE": module,
            "CONT_PREPROCESSING": preprocessing,
            "CONT_WINDOW": str(CONT_WINDOW),
            "CONT_MIN_ACCURACY": str(RETRAIN_MIN_ACCURACY),
            "CONT_MAX_DROP": str(CONT_MAX_DROP),
            "CONT_PROBATION_S": str(CONT_PROBATION_S),
            "CONT_NODE_TIMEOUT_S": str(CONT_NODE_TIMEOUT_S),
            "CONT_DEVICE": DEVICE}


def minus(after, before):
    return {k: after[k] - before[k] for k in after}


def continuous_phase(seed, card, workdir, production_uri):
    """The continuous controller on the card (ContinuousController from
    CONTINUOUS_PIPELINE's ``create_continuous``, in this process, with a
    state dir): spans of TFRecord reviews land under
    ``data/span-{SPAN}/v-{VERSION}``; each new span runs the span pipeline
    (ImportExampleGen -> StatisticsGen with accumulators), then the window
    pipeline retrains BERT-base over the last CONT_WINDOW spans from the
    production model and pushes into the guarded BERT fleet (booted on
    production, probation CONT_PROBATION_S).  Ticks: spans 1-2 land (two
    span runs, a window run, a deploy through the canary and its captured
    buckets, a healthy probation under traffic); nothing new (an idle
    tick, no run, no launch); span 3 lands (one span run, work saved 0.5,
    window [2, 3], a deploy; DEVICE_ERROR on every replica once version 3
    serves, rolled back to version 2 inside probation, observed, the
    blessing un-blessed in the store); the merged statistics of [2, 3]
    against a cold StatisticsGen byte for byte; a restarted controller
    reprocesses nothing and a pending marker resumes the window run with
    every node adopted and no deploy; a drift breach triggers an
    out-of-cadence window run, all cache hits.  Launches are read inside
    the runner each tick.  Returns each kernel's launches over the phase."""
    import dataclasses

    from tpu_pipelines_torch.components import Importer, StatisticsGen
    from tpu_pipelines_torch.components import pusher as pusher_module
    from tpu_pipelines_torch.components.resolver import resolve_artifacts
    from tpu_pipelines_torch.continuous import ContinuousController
    from tpu_pipelines_torch.data import examples_io
    from tpu_pipelines_torch.dsl.pipeline import Pipeline
    from tpu_pipelines_torch.examples import bert_pipeline
    from tpu_pipelines_torch.metadata import open_store
    from tpu_pipelines_torch.observability.metrics import MetricsRegistry
    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.robustness.atomic import atomic_write_json
    from tpu_pipelines_torch.testing import faults
    from tpu_pipelines_torch.utils.module_loader import load_fn, load_module

    base = os.path.join(workdir, "continuous")
    fleet_dir = os.path.join(base, "fleet")
    os.makedirs(base)
    payload_copy(production_uri, os.path.join(fleet_dir, "1"))
    vocab_file = os.path.join(base, "vocab.txt")
    production_vocabulary(production_uri, vocab_file)
    preprocessing = os.path.join(base, "preprocessing.py")
    with open(preprocessing, "w") as f:
        f.write(RETRAIN_PREPROCESSING.format(vocab_file=vocab_file))
    module_path = os.path.join(base, "continuous_pipeline.py")
    with open(module_path, "w") as f:
        f.write(CONTINUOUS_PIPELINE)
    hp = dict(bert_pipeline.BERT_BASE)
    module_file = os.path.join(bert_pipeline.HERE, "bert_module.py")
    batch = hp["batch_size"]
    layers = DEFAULT_HPARAMS["n_layers"]
    flash = tfm.choose_attn_impl(batch, DEFAULT_HPARAMS["n_heads"],
                                 PIPELINE_LEN, PIPELINE_LEN, 2,
                                 torch.device(DEVICE)) == "flash"
    rng = np.random.default_rng(seed + 23)
    unseen = [(review_text(i, t, "she wrote"), label) for i, (t, label) in
              enumerate(review_rows(seed, 512, part=9))]

    server = ModelServer(
        "bert", fleet_dir, replicas=FLEET_REPLICAS, max_versions=2,
        slo_p99_ms=FLEET_SLO_MS, max_batch_size=FLEET_BATCH,
        supervisor_interval_s=FLEET_SUPERVISOR_S,
        slo_monitor_interval_s=GUARD_MONITOR_S,
        swap_probation_s=CONT_PROBATION_S, device=DEVICE)
    fleet = server._fleet
    replicas = fleet.pool.replicas
    registry = MetricsRegistry()
    user = load_module(module_file)
    real_loop, real_run = user.train_loop, LocalDagRunner.run
    real_notify = pusher_module.notify_serving
    graph = torch.cuda.CUDAGraph
    real_capture = graph.capture_begin
    captures = [0]
    tick = {}

    def loop(**kw):
        model, result = real_loop(**kw)
        tick["after_trainer"], tick["train"] = counters(), result
        return model, result

    def run(self, *args, **kwargs):
        tick.setdefault("runs", []).append(real_run(self, *args, **kwargs))
        return tick["runs"][-1]

    def counted_capture(self, *args, **kwargs):
        captures[0] += 1
        return real_capture(self, *args, **kwargs)

    def traffic(url, fault):
        """After a deploy: GUARD_REQUESTS requests served by the new
        version (their launches and device batches counted); with
        ``fault``, DEVICE_ERROR on every replica instead, from clients
        that keep sending until the fleet rolls back."""
        out = tick["traffic"] = {"version": fleet.active_version}
        c0, b0 = counters(), sum(r.batcher.batches_run for r in replicas)
        if not fault:
            results, out["seconds"] = run_clients(
                f"{url}:predict", review_requests(rng, unseen, GUARD_REQUESTS),
                n_procs=1, threads=GUARD_THREADS)
            out["codes"] = sorted({c for c, _, _ in results})
            out["requests"] = len(results)
            out["launches"] = minus(counters(), c0)
            out["batches"] = (sum(r.batcher.batches_run for r in replicas)
                              - b0)
            return
        plan = faults.FaultPlan({faults.REPLICA_KEY: faults.NodeFault(
            faults.DEVICE_ERROR, times=10 ** 6)})
        stop, codes, first_bad = threading.Event(), [], []
        after = review_requests(rng, unseen, GUARD_REQUESTS // 2)

        def faulty(i):
            while not stop.is_set():
                code, _ = post_code(f"{url}:predict", after[i % len(after)])
                codes.append(code)
                if code >= 500 and not first_bad:
                    first_bad.append(time.monotonic())

        captures0 = captures[0]
        with plan.activate():
            threads = [threading.Thread(target=faulty, args=(i,))
                       for i in range(GUARD_THREADS)]
            for t in threads:
                t.start()
            try:
                wait_for(lambda: fleet.active_version != out["version"], 60,
                         "the rollback")
            finally:
                stop.set()
                for t in threads:
                    t.join()
        out.update(codes=sorted(set(codes)), n_faulty=len(codes),
                   first_bad=first_bad[0] if first_bad else None,
                   rollback=fleet.versions.last_swap(),
                   captures=captures[0] - captures0,
                   launches=minus(counters(), c0))

    def notify(url, *args, **kwargs):
        """The Pusher's :reload: the counters before it (the window run's
        Trainer and Evaluator), the deploy's own launches, then the
        traffic (and the fault) in a thread of its own."""
        tick["before_notify"] = counters()
        verdict = real_notify(url, *args, **kwargs)
        tick["deploy"] = minus(counters(), tick["before_notify"])
        tick["swap"] = fleet.versions.last_swap()
        tick["traffic_thread"] = threading.Thread(
            target=traffic, args=(url, tick["fault"]))
        tick["traffic_thread"].start()
        return verdict

    def run_tick(name, controller, before=None, fault=False):
        tick.clear()
        tick["fault"] = fault
        if before is not None:
            before()
        zero_counters()
        t0 = time.perf_counter()
        summary = controller.run_once()
        wall = time.perf_counter() - t0
        thread = tick.get("traffic_thread")
        if thread is not None:
            thread.join()
        rec = {"name": name, "summary": summary, "wall": wall,
               "launches": counters(), **tick}
        print(f"continuous {name} [{card}]: {wall:.1f} s; "
              f"deliveries {summary['deliveries']}, spans processed "
              f"{summary['spans_processed']}, nodes executed "
              f"{summary['nodes_executed']} / cached {summary['nodes_cached']},"
              f" work saved {summary['work_saved_ratio']}, deployed "
              f"{(summary['deployed'] or {}).get('version')}, rollback "
              f"observed {summary.get('rollback_observed')}; launches "
              f"{rec['launches']}", flush=True)
        for r in tick.get("runs", []):
            print(f"continuous {name} run {r.run_id}: " + ", ".join(
                f"{k} {v.status}{' adopted' if v.adopted else ''} "
                f"{v.wall_clock_s:.2f} s" for k, v in r.nodes.items()),
                flush=True)
        return rec

    def landed(*spans):
        """Write the spans' TFRecords; the monotonic time they landed."""
        def write():
            for span in spans:
                write_span(os.path.join(base, "data", f"span-{span}", "v-1"),
                           seed, span, CONT_ROWS)
            tick["landed"] = time.monotonic()
        return write

    url = None
    try:
        with mock.patch.object(graph, "capture_begin", counted_capture), \
                mock.patch.object(LocalDagRunner, "run", run), \
                mock.patch.object(user, "train_loop", loop), \
                mock.patch.object(pusher_module, "notify_serving", notify):
            url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/bert"
            # Production serves traffic before the first deploy (its first
            # batch captures its buckets), as a live fleet's would: the
            # SLO monitor's windows judge each swap against it.
            boot, boot_s = run_clients(
                f"{url}:predict", review_requests(rng, unseen, GUARD_REQUESTS),
                n_procs=1, threads=GUARD_THREADS)
            if {c for c, _, _ in boot} != {200}:
                raise AssertionError(f"continuous: production's replies "
                                     f"{sorted({c for c, _, _ in boot})}")
            print(f"continuous [{card}]: the fleet on production served "
                  f"{len(boot)} requests in {boot_s:.2f} s before the first "
                  f"span landed", flush=True)
            env = continuous_env(base, fleet_dir, url, production_uri, hp,
                                 module_file, preprocessing)
            with mock.patch.dict(os.environ, env):
                cfg = dataclasses.replace(
                    load_fn(module_path, "create_continuous")(),
                    registry=registry)
                ctl = ContinuousController(cfg)
                t1 = run_tick("tick 1 (spans 1-2 land)", ctl,
                              before=landed(1, 2))
                idle = run_tick("tick 2 (nothing new)", ctl)
                t3 = run_tick("tick 3 (span 3 lands)", ctl,
                              before=landed(3), fault=True)
                # Restart: a new controller on the same state dir.
                restarted = run_tick("restart", ContinuousController(cfg))
                atomic_write_json(os.path.join(base, "state", "pending.json"),
                                  {"pipeline": "bert-window",
                                   "kind": "window"})
                ctl2 = ContinuousController(cfg)
                deploys0 = registry.get("continuous_deploys_total").get()
                resumed = run_tick("crash marker", ctl2)
                deploys1 = registry.get("continuous_deploys_total").get()
                ctl2.notify_drift({"slo": "drift", "feature": "text",
                                   "kind": "skew_linf", "distance": 0.5})
                drift = run_tick("drift breach", ctl2)
            # The window [2, 3]'s merged statistics against a cold pass.
            store = open_store(os.path.join(base, "metadata.sqlite"))
            try:
                merged_art = max(
                    (a for a in store.get_artifacts(
                        type_name="ExampleStatistics")
                     if a.properties.get("window_spans") == [2, 3]),
                    key=lambda a: a.id)
                window_art = max(
                    (a for a in store.get_artifacts(type_name="Examples")
                     if a.properties.get("window_spans") == [2, 3]),
                    key=lambda a: a.id)
                blessings = store.get_artifacts(type_name="ModelBlessing")
                models = store.get_artifacts(type_name="Model")
                baseline = resolve_artifacts(
                    store, strategy="latest_blessed_model",
                    pipeline_name="bert-window")["model"]
                evidence = store.get_contexts("drift_evidence")
            finally:
                store.close()
            imp = Importer(source_uri=window_art.uri, artifact_type="Examples")
            cold_stats = StatisticsGen(examples=imp.outputs["result"])
            t0 = time.perf_counter()
            cold = real_run(LocalDagRunner(device=DEVICE), Pipeline(
                "cold-window", [imp, cold_stats],
                pipeline_root=os.path.join(base, "cold"),
                metadata_path=os.path.join(base, "cold.sqlite")))
            cold_s = time.perf_counter() - t0
    finally:
        server.stop()

    with open(os.path.join(cold.outputs_of("StatisticsGen", "statistics")[0]
                           .uri, "stats.json"), "rb") as f:
        cold_bytes = f.read()
    with open(os.path.join(merged_art.uri, "stats.json"), "rb") as f:
        merged_bytes = f.read()

    def window_run(rec):
        (r,) = [r for r in rec["runs"] if r.pipeline_name == "bert-window"]
        return r

    # Launches inside the runner: the Trainer's steps and eval batches, the
    # Evaluator's passes, then (after the Pusher's notify) the deploy and
    # the traffic the new version served.
    problems = []
    for rec, passes in ((t1, 1), (t3, 2)):
        if "traffic" not in rec:
            problems.append(f"continuous {rec['name']}: no deploy")
            continue
        r = window_run(rec)
        uri = r.outputs_of("Transform", "transformed_examples")[0].uri
        n_eval = examples_io.num_rows(uri, "eval")
        steps = layers * CONT_STEPS * flash
        trainer_fwd = steps + layers * (n_eval // batch) * flash
        want = {"launches": trainer_fwd + passes * layers * -(-n_eval // batch)
                * flash, "dvec_launches": steps, "dq_launches": steps,
                "dkv_launches": steps, "decode_launches": 0}
        if (rec.get("before_notify") != want
                or rec.get("after_trainer") != {**want,
                                                "launches": trainer_fwd}):
            problems.append(
                f"continuous {rec['name']}: before the deploy "
                f"{rec.get('before_notify')} (after the Trainer "
                f"{rec.get('after_trainer')}), expected {want} (auto = "
                f"{'flash' if flash else 'dense'})")
        served = rec["traffic"]
        traffic_l = served["launches"]
        if (any(v for k, v in traffic_l.items() if k != "launches")
                or any(v for k, v in rec["deploy"].items()
                       if k != "launches")
                or ("requests" in served and (
                    served["codes"] != [200]
                    or traffic_l["launches"] != layers * served["batches"]))):
            problems.append(
                f"continuous {rec['name']}: deploy {rec['deploy']}, traffic "
                f"{traffic_l} over {served.get('batches')} batches, replies "
                f"{served['codes']}")
        total = {k: want[k] + rec["deploy"][k] + traffic_l[k] for k in want}
        if rec["launches"] != total:
            problems.append(f"continuous {rec['name']}: launches "
                            f"{rec['launches']}, parts sum to {total}")
        res = rec["train"]
        spans = r.outputs_of("SpanWindow", "window")[0].properties[
            "window_spans"]
        print(f"continuous {rec['name']} [{card}]: window {spans}; Trainer "
              f"{res.steps_completed} "
              f"steps at batch {batch} x {PIPELINE_LEN} warm-started from "
              f"production, {res.examples_per_sec:.1f} examples/s over the "
              f"run, Evaluator {passes} pass(es) over {n_eval} eval rows; "
              f"deploy: {rec['deploy']['launches']} flash_fwd launches at "
              f"the canary; version {served['version']} then "
              + (f"served {served['requests']} requests in "
                 f"{served['batches']} device batches ({traffic_l['launches']}"
                 f" launches) in {served['seconds']:.2f} s"
                 if "requests" in served else
                 f"took DEVICE_ERROR on every replica ({served['n_faulty']} "
                 f"replies {served['codes']}, {traffic_l['launches']} "
                 "launches)")
              + "; deploy_to_serving_s "
              f"{rec['swap']['mono'] - rec['landed']:.3f} (span files "
              f"landed -> the fleet serves the retrain)", flush=True)

    s1, s3 = t1["summary"], t3["summary"]
    if (s1["spans_processed"] != 2 or s1["work_saved_ratio"] != 0.0
            or (s1["deployed"] or {}).get("version") != "2"
            or s1.get("rollback_observed") is not False
            or t1["traffic"]["version"] != "2" or t1["swap"]["rollback"]
            or len(t1["runs"]) != 3):
        raise AssertionError(f"continuous tick 1: {s1}, swap {t1.get('swap')}"
                             f", after the probation "
                             f"{fleet.versions.last_swap()}")
    if (idle["summary"]["nodes_executed"] or idle["summary"]["nodes_cached"]
            or "runs" in idle or any(idle["launches"].values())):
        raise AssertionError(f"continuous idle tick: {idle['summary']}, "
                             f"launches {idle['launches']}")
    if problems:
        raise AssertionError("; ".join(problems))
    rb = t3["traffic"]
    window3 = window_run(t3)
    spans3 = window3.outputs_of("SpanWindow", "window")[0].properties[
        "window_spans"]
    if (s3["spans_processed"] != 1 or s3["work_saved_ratio"] != 0.5
            or spans3 != [2, 3] or s3["deliveries"] != ["3:1"]
            or (s3["deployed"] or {}).get("version") != "3"
            or s3.get("rollback_observed") is not True
            or rb["version"] != "3" or not rb["rollback"]["rollback"]
            or rb["rollback"]["version"] != "2" or rb["first_bad"] is None
            or rb["rollback"]["mono"] - t3["swap"]["mono"] > CONT_PROBATION_S
            or rb["captures"]):
        raise AssertionError(f"continuous tick 3: {s3}, window {spans3}, "
                             f"swap {t3['swap']}, fault {rb}")
    unblessed = [b for b in blessings if b.properties.get("blessed") is False]
    bad = [m for m in models if m.properties.get("rollback_quarantined")]
    model1 = window_run(t1).outputs_of("Trainer", "model")[0]
    model3 = window3.outputs_of("Trainer", "model")[0]
    if (len(unblessed) != 1
            or "auto-rollback" not in unblessed[0].properties["unblessed_reason"]
            or not os.path.exists(os.path.join(unblessed[0].uri,
                                               "NOT_BLESSED"))
            or os.path.exists(os.path.join(unblessed[0].uri, "BLESSED"))
            or [m.id for m in bad] != [model3.id]
            or [m.id for m in baseline] != [model1.id]
            or registry.get("continuous_rollbacks_observed_total").get() != 1):
        raise AssertionError(
            f"continuous: store after the rollback: unblessed "
            f"{[(b.id, b.properties) for b in unblessed]}, quarantined "
            f"models {[m.id for m in bad]} (version 3's {model3.id}), "
            f"latest blessed {[m.id for m in baseline]} (version 2's "
            f"{model1.id})")
    if merged_bytes != cold_bytes:
        raise AssertionError("continuous: the window [2, 3]'s merged "
                             "stats.json differs from a cold StatisticsGen's")
    rs = restarted["summary"]
    if rs["spans_processed"] or rs["nodes_executed"] or rs["nodes_cached"] \
            or "runs" in restarted or any(restarted["launches"].values()):
        raise AssertionError(f"continuous restart: {rs}")
    (resumed_run,) = resumed["runs"]
    if (resumed["summary"]["deployed"] is not None or deploys1 != deploys0
            or deploys1 != 2
            or not all(nr.adopted for nr in resumed_run.nodes.values())
            or resumed_run.run_id != window3.run_id
            or any(resumed["launches"].values())):
        raise AssertionError(
            f"continuous crash marker: {resumed['summary']}, deploys "
            f"{deploys0} -> {deploys1}, run {resumed_run.run_id} (tick 3's "
            f"{window3.run_id}), adopted "
            f"{[k for k, v in resumed_run.nodes.items() if v.adopted]}")
    (drift_run,) = drift["runs"]
    statuses = {k: v.status for k, v in drift_run.nodes.items()}
    want_statuses = {k: "CACHED" for k in statuses}
    want_statuses["RollingWindowResolver"] = "COMPLETE"
    if (statuses != want_statuses or not drift["summary"].get("drift_triggered")
            or drift["summary"]["deployed"] is not None
            or any(drift["launches"].values())
            or registry.get("continuous_drift_triggered_runs_total").get() != 1
            or [c.name for c in evidence] != [drift_run.run_id]):
        raise AssertionError(f"continuous drift: {drift['summary']}, "
                             f"{statuses}, evidence "
                             f"{[c.name for c in evidence]}")
    print(f"continuous [{card}]: rollback of version 3 -> 2 "
          f"{rb['rollback']['mono'] - t3['swap']['mono']:.3f} s after its "
          f"swap, breach-to-rollback {rb['rollback']['mono'] - rb['first_bad']:.3f}"
          f" s (first 5xx reply -> the fleet serves version 2), "
          f"{rb['n_faulty']} replies {rb['codes']} under DEVICE_ERROR, "
          f"{rb['captures']} captures at the rollback; the blessing of "
          f"version 3 un-blessed (NOT_BLESSED written), its model "
          f"rollback_quarantined, latest blessed = version 2's model "
          f"(artifact {model1.id}); window [2, 3] merged stats.json == a cold "
          f"StatisticsGen's byte for byte ({len(merged_bytes)} bytes; cold "
          f"run {cold_s:.2f} s); restart: idle; crash marker: run "
          f"{resumed_run.run_id} resumed, {len(resumed_run.nodes)} nodes "
          f"adopted, no deploy (continuous_deploys_total {deploys1:g}); "
          f"drift breach: run {drift_run.run_id} all cache hits but the "
          f"resolver, drift_evidence recorded", flush=True)
    total = {k: sum(rec["launches"][k] for rec in
                    (t1, idle, t3, restarted, resumed, drift))
             for k in fa.COUNTERS}
    return by_record(total)


# ----------------------------------------------------------- DAG machinery

# The partial rerun's Trainer steps (the bert_dag phase ran 100).
MACHINERY_STEPS = 40
# Shards of the StatisticsGen runs over the bert_dag phase's examples.
MACHINERY_SHARDS = 4
# The StatisticsGen runs' node deadline: its watchdog's cancel event kills
# the fork pool's workers (a child wedged on a lock another thread held at
# the fork).
MACHINERY_NODE_TIMEOUT_S = 120
ITEM_HAZARD = "    loss = F.cross_entropy(logits.float(), labels)\n"
HAZARD_PIPELINE = """\
import os

from tpu_pipelines_torch.examples import bert_pipeline


def create_pipeline():
    pipeline = bert_pipeline.create_pipeline()
    trainer = next(c for c in pipeline.components if c.id == "Trainer")
    trainer.exec_properties["module_file"] = {module!r}
    return pipeline
"""
STATS_PIPELINE = """\
import os

from tpu_pipelines_torch.components import StatisticsGen
from tpu_pipelines_torch.components.importer import Importer
from tpu_pipelines_torch.dsl.pipeline import Pipeline


def create_pipeline():
    base = os.environ["MACHINERY_STATS_BASE"]
    examples = Importer(source_uri=os.environ["MACHINERY_EXAMPLES"],
                        artifact_type="Examples")
    stats = StatisticsGen(
        examples=examples.outputs["result"],
        salvage_shards=os.environ.get("MACHINERY_SALVAGE") == "1")
    return Pipeline("stats-pool", [examples, stats],
                    pipeline_root=os.path.join(base, "root"),
                    metadata_path=os.path.join(base, "md.sqlite"))
"""


def store_executions(path):
    """Every execution in the store at ``path`` (the Python backend)."""
    from tpu_pipelines_torch.metadata.store import MetadataStore

    store = MetadataStore(path)
    try:
        return store.get_executions()
    finally:
        store.close()


def latest_outputs(path, node):
    """Artifact ids of ``node``'s newest COMPLETE execution, by key."""
    from tpu_pipelines_torch.metadata.store import MetadataStore
    from tpu_pipelines_torch.metadata.types import EventType, ExecutionState

    store = MetadataStore(path)
    try:
        ex = [e for e in store.get_executions(node_id=node)
              if e.state == ExecutionState.COMPLETE][-1]
        out = {}
        for ev in store.get_events_by_execution(ex.id):
            if ev.type == EventType.OUTPUT:
                out.setdefault(ev.path, []).append(ev.artifact_id)
        return out
    finally:
        store.close()


def stats_run(workdir, tag, examples_uri, pool, salvage=False, plan=None):
    """StatisticsGen over ``examples_uri`` through ``python -m
    tpu_pipelines_torch run`` (in this process) on a fresh pipeline root,
    with TPP_DATA_POOL=``pool`` and MACHINERY_SHARDS shards: (stats.json
    bytes, the node's execution properties, the pids of its shard spans,
    seconds)."""
    from tpu_pipelines_torch.observability.export import read_events
    from tpu_pipelines_torch.observability.trace import events_path

    base = os.path.join(workdir, f"stats-{tag}")
    module = os.path.join(workdir, "stats_pipeline.py")
    if not os.path.exists(module):
        with open(module, "w") as f:
            f.write(STATS_PIPELINE)
    env = {"MACHINERY_STATS_BASE": base, "MACHINERY_EXAMPLES": examples_uri,
           "MACHINERY_SALVAGE": "1" if salvage else "0",
           "TPP_DATA_POOL": pool, "TPP_DATA_SHARDS": str(MACHINERY_SHARDS),
           "TPP_NODE_TIMEOUT_S": str(MACHINERY_NODE_TIMEOUT_S)}
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, env), (
            plan.activate() if plan is not None else contextlib.nullcontext()):
        code, out = cli(["run", "--pipeline-module", module,
                         "--device", DEVICE])
    seconds = time.perf_counter() - t0
    if code != 0:
        raise AssertionError(f"dag_machinery stats {tag}: exit {code}: "
                             f"{out[-2000:]}")
    run_id = re.search(r"run (stats-pool-\d+)", out).group(1)
    execs = [e for e in store_executions(os.path.join(base, "md.sqlite"))
             if e.node_id == "StatisticsGen"]
    uri = os.path.join(base, "root", "StatisticsGen", "statistics",
                       str(execs[-1].id))
    with open(os.path.join(uri, "stats.json"), "rb") as f:
        data = f.read()
    events = read_events(events_path(os.path.join(base, "root"), run_id))
    pids = sorted({e["pid"] for e in events
                   if e.get("name") == "shard" and e.get("cat") == "data"})
    return data, execs[-1].properties, pids, seconds


def dag_machinery_phase(seed, card, workdir):
    """Lint, a partial rerun on the native store, and the fork shard pool,
    over what the bert_dag phase left in ``workdir``: its store
    (``bert/metadata.sqlite``, written by the Python backend), its
    artifacts and its CSV.  Returns each kernel's launches in the partial
    rerun."""
    del seed
    from tpu_pipelines_torch.data import examples_io, shard_plan
    from tpu_pipelines_torch.examples import bert_pipeline
    from tpu_pipelines_torch.metadata import native_store
    from tpu_pipelines_torch.orchestration import local_runner
    from tpu_pipelines_torch.testing import faults
    from tpu_pipelines_torch.utils.module_loader import load_module

    base = os.path.join(workdir, "bert")
    md = os.path.join(base, "metadata.sqlite")
    bert_env = {"TPP_PIPELINE_HOME": base,
                "BERT_DATA_CSV": os.path.join(workdir, "reviews.csv"),
                "BERT_TINY": ""}
    examples_dir = os.path.join(REPO, "tpu_pipelines_torch", "examples")

    # 1. Each example pipeline lints clean at the error level.
    t0 = time.perf_counter()
    linted = {}
    with mock.patch.dict(os.environ, {
            "TPP_PIPELINE_HOME": os.path.join(workdir, "lint-home")}):
        for name in ("taxi", "bert", "t5"):
            code, out = cli(["lint", "--pipeline-module", os.path.join(
                examples_dir, f"{name}_pipeline.py"), "--json"])
            report = json.loads(out)
            if code != 0 or report["errors"]:
                raise AssertionError(f"dag_machinery lint {name}: exit "
                                     f"{code}, {report}")
            linted[name] = (report["errors"], report["warnings"])
    lint_s = time.perf_counter() - t0

    # 2. A module with a host sync inside the captured loss_fn: TPP203 at
    #    ERROR, and `run --lint error` refuses before anything runs.
    with open(os.path.join(examples_dir, "bert_module.py")) as f:
        source = f.read()
    if source.count(ITEM_HAZARD) != 1:
        raise AssertionError("dag_machinery: bert_module.py's loss_fn moved")
    hazard = os.path.join(workdir, "bert_module_item.py")
    with open(hazard, "w") as f:
        f.write(source.replace(ITEM_HAZARD, ITEM_HAZARD
                               + "    print(\"loss\", loss.item())\n"))
    hazard_pipeline = os.path.join(workdir, "hazard_pipeline.py")
    with open(hazard_pipeline, "w") as f:
        f.write(HAZARD_PIPELINE.format(module=hazard))
    before = len(store_executions(md))
    zero_counters()
    with mock.patch.dict(os.environ, bert_env):
        code, out = cli(["lint", "--pipeline-module", hazard_pipeline,
                         "--json"])
        found = [(f["rule"], f["severity"], f["node_id"], f["line"])
                 for f in json.loads(out)["findings"] if f["rule"] == "TPP203"]
        refused, _ = cli(["run", "--pipeline-module", hazard_pipeline,
                          "--device", DEVICE, "--lint", "error"])
    item_line = source.splitlines().index(ITEM_HAZARD.rstrip("\n")) + 2
    if (code, refused) != (3, 3) or found != [
            ("TPP203", "error", "Trainer", item_line)]:
        raise AssertionError(f"dag_machinery: hazard lint exit {code} "
                             f"{found}, run --lint error exit {refused}")
    if any(counters().values()) or len(store_executions(md)) != before:
        raise AssertionError("dag_machinery: a refused run launched a kernel "
                             "or wrote the store")
    print(f"dag_machinery lint [{card}]: taxi, bert, t5 example pipelines "
          f"(errors, warnings) {linted} in {lint_s:.2f} s; bert_module with "
          f".item() in loss_fn: {found[0][0]} {found[0][1]} at line "
          f"{found[0][3]}, `run --lint error` exit 3 with no launch and "
          f"{before} executions in the store before and after", flush=True)

    # 3. `run --from-node Trainer` over bert_dag's store on the native
    #    backend, 40 steps: ingest..Transform SKIPPED with bert_dag's
    #    artifacts, Trainer and Evaluator executed on the card.
    pipeline_module = os.path.join(examples_dir, "bert_pipeline.py")
    skipped_nodes = ("CsvExampleGen", "StatisticsGen", "SchemaGen",
                     "Transform")
    prior = {n: latest_outputs(md, n) for n in skipped_nodes}
    user = load_module(os.path.join(examples_dir, "bert_module.py"))
    real_loop, real_open = user.train_loop, local_runner.open_store
    real_run = local_runner.LocalDagRunner.run
    seen = {"stores": [], "results": []}

    def loop(**kw):
        model, result = real_loop(**kw)
        seen["after_trainer"], seen["train"] = counters(), result
        return model, result

    def opened(path, *args, **kwargs):
        store = real_open(path, *args, **kwargs)
        seen["stores"].append(type(store))
        return store

    def run(self, *args, **kwargs):
        seen["results"].append(real_run(self, *args, **kwargs))
        return seen["results"][-1]

    env = {**bert_env, "TPP_METADATA_BACKEND": "native",
           "BERT_TRAIN_STEPS": str(MACHINERY_STEPS)}
    with mock.patch.dict(os.environ, env), \
            mock.patch.object(user, "train_loop", loop), \
            mock.patch.object(local_runner, "open_store", opened), \
            mock.patch.object(local_runner.LocalDagRunner, "run", run):
        zero_counters()
        t0 = time.perf_counter()
        code, out = cli(["run", "--pipeline-module", pipeline_module,
                         "--device", DEVICE, "--from-node", "Trainer"])
        partial_s = time.perf_counter() - t0
        launches = counters()
    if code != 0:
        raise AssertionError(f"dag_machinery: partial rerun exit {code}: "
                             f"{out[-2000:]}")
    result = seen["results"][-1]
    statuses = {k: v.status for k, v in result.nodes.items()}
    want_statuses = {**{n: "SKIPPED" for n in skipped_nodes},
                     "Trainer": "COMPLETE", "Evaluator": "COMPLETE"}
    reused = {n: {k: [a.id for a in arts]
                  for k, arts in result.nodes[n].outputs.items()}
              for n in skipped_nodes}
    if statuses != want_statuses or reused != prior:
        raise AssertionError(f"dag_machinery: partial rerun {statuses}, "
                             f"reused {reused}, bert_dag's {prior}")
    lib = native_store.library_path()
    if seen["stores"] != [native_store.NativeMetadataStore] or not lib.startswith(
            os.path.join(REPO, "tpu_pipelines_torch", "_build") + os.sep):
        raise AssertionError(f"dag_machinery: the run's stores {seen['stores']}"
                             f" (library {lib})")
    # Launches from inside the runner, as bert_dag's at 40 steps.
    layers = DEFAULT_HPARAMS["n_layers"]
    batch = bert_pipeline.BERT_BASE["batch_size"]
    examples_uri = result.nodes["Transform"].outputs[
        "transformed_examples"][0].uri
    n_eval = examples_io.num_rows(examples_uri, "eval")
    impl = tfm.choose_attn_impl(batch, DEFAULT_HPARAMS["n_heads"],
                                PIPELINE_LEN, PIPELINE_LEN, 2,
                                torch.device(DEVICE))
    if impl != "flash":
        raise AssertionError(f"dag_machinery: auto chose {impl}")
    steps = layers * MACHINERY_STEPS
    trainer_fwd = steps + layers * (n_eval // batch)
    want = {"launches": trainer_fwd + layers * -(-n_eval // batch),
            "dvec_launches": steps, "dq_launches": steps,
            "dkv_launches": steps, "decode_launches": 0}
    if (launches != want or seen["after_trainer"] != {
            **want, "launches": trainer_fwd}
            or seen["train"].steps_completed != MACHINERY_STEPS
            or seen["train"].compiles_after_warm != 0):
        raise AssertionError(f"dag_machinery: launches {launches} (after the "
                             f"Trainer {seen['after_trainer']}), expected "
                             f"{want}")
    code, out = cli(["inspect", "runs", "bert-finetune", "--metadata", md,
                     "--json"])
    runs = json.loads(out)["runs"]
    last = runs[-1]
    listed = sorted((n["node"], n["state"]) for n in last["nodes"])
    if code != 0 or last["run_id"] != result.run_id or listed != [
            ("Evaluator", "COMPLETE"), ("Trainer", "COMPLETE")]:
        raise AssertionError(f"dag_machinery: inspect runs {code} {last}")
    print(f"dag_machinery partial rerun [{card}]: `run --from-node Trainer` "
          f"on {seen['stores'][0].__name__} ({os.path.basename(lib)}) over "
          f"the Python-written store, {partial_s:.1f} s: "
          + ", ".join(f"{k} {v.status}"
                      + (f" {v.wall_clock_s:.2f} s" if v.wall_clock_s else "")
                      for k, v in result.nodes.items())
          + f"; launches {by_record(launches)} = {layers} layers x "
          f"({MACHINERY_STEPS} steps + {n_eval // batch} Trainer eval batches "
          f"+ {-(-n_eval // batch)} Evaluator batches) forwards and {layers} x "
          f"{MACHINERY_STEPS} of each backward kernel; `inspect runs` (Python "
          f"backend) lists {len(runs)} runs, the last {last['run_id']} with "
          f"{listed}", flush=True)

    # 4. `run --to-node Transform`: every selected node a cache hit, the
    #    rest SKIPPED, nothing launched.
    with mock.patch.dict(os.environ, bert_env), \
            mock.patch.object(local_runner.LocalDagRunner, "run", run):
        zero_counters()
        t0 = time.perf_counter()
        code, out = cli(["run", "--pipeline-module", pipeline_module,
                         "--device", DEVICE, "--to-node", "Transform"])
        to_s = time.perf_counter() - t0
    to = {k: v.status for k, v in seen["results"][-1].nodes.items()}
    if code != 0 or any(counters().values()) or to != {
            **{n: "CACHED" for n in skipped_nodes},
            "Trainer": "SKIPPED", "Evaluator": "SKIPPED"}:
        raise AssertionError(f"dag_machinery: --to-node Transform {code} {to} "
                             f"{counters()}")
    print(f"dag_machinery [{card}]: `run --to-node Transform` {to_s:.2f} s, "
          f"{to}, no launch", flush=True)

    # 5. StatisticsGen over bert_dag's examples through the fork pool, in
    #    this process (which holds a CUDA context and has launched kernels).
    raw_uri = result.nodes["CsvExampleGen"].outputs["examples"][0].uri
    n_files = examples_io.num_split_shards(raw_uri, "train")
    thread_bytes, _, thread_pids, thread_s = stats_run(
        workdir, "thread", raw_uri, "thread")
    proc_bytes, _, proc_pids, proc_s = stats_run(
        workdir, "process", raw_uri, "process")
    parent = os.getpid()
    if (proc_bytes != thread_bytes or thread_pids != [parent]
            or not proc_pids or parent in proc_pids):
        raise AssertionError(f"dag_machinery: fork pool stats.json "
                             f"{len(proc_bytes)} bytes == thread's "
                             f"{proc_bytes == thread_bytes}; pids {proc_pids} "
                             f"(parent {parent}), thread pids {thread_pids}")
    deaths = shard_plan._worker_death_counter().labels("map_shards")
    deaths0 = deaths.get()
    plan = faults.FaultPlan({faults.SHARD_KEY: faults.NodeFault(
        faults.KILL_SHARD_WORKER, shard=1)})
    killed_bytes, _, killed_pids, killed_s = stats_run(
        workdir, "killed", raw_uri, "process", plan=plan)
    died = deaths.get() - deaths0
    if killed_bytes != thread_bytes or died < 1:
        raise AssertionError(f"dag_machinery: KILL_SHARD_WORKER: bytes equal "
                             f"{killed_bytes == thread_bytes}, deaths {died}")
    # One shard of a copy of the examples cut short: it fails on every
    # attempt; with salvage_shards the node completes without it.
    poisoned = os.path.join(workdir, "poisoned_examples")
    shutil.copytree(raw_uri, poisoned)
    victim = examples_io.split_shard_paths(poisoned, "train")[2]
    with open(victim, "r+b") as f:
        f.truncate(64)
    _, salvage_props, _, salvage_s = stats_run(
        workdir, "salvage", poisoned, "process", salvage=True)
    struck = salvage_props.get("quarantined_shards", {})
    if list(struck) != ["train"] or list(struck["train"]) != ["2"] or (
            salvage_props.get("partial_statistics") is not True):
        raise AssertionError(f"dag_machinery: salvage {salvage_props}")
    print(f"dag_machinery shard pool [{card}]: StatisticsGen over bert_dag's "
          f"examples ({n_files} train shard files, TPP_DATA_SHARDS="
          f"{MACHINERY_SHARDS}): fork pool stats.json == thread pool's byte "
          f"for byte ({len(proc_bytes)} bytes) from worker pids {proc_pids} "
          f"(parent {parent}); thread {thread_s:.2f} s, process "
          f"{proc_s:.2f} s; KILL_SHARD_WORKER on shard 1: pool replaced, "
          f"{died:g} worker death counted, same bytes, {killed_s:.2f} s "
          f"(pids {killed_pids}); shard 2 cut to 64 bytes with "
          f"salvage_shards: node COMPLETE in {salvage_s:.2f} s, quarantined "
          f"{struck}", flush=True)
    return by_record(launches)


# ------------------------------------------------------------------ T5 DAG

T5_DAG_PAIRS = 1536
T5_DAG_STEPS = 100
T5_LEXICON = 1500


def pairs_csv(path, seed, rows):
    """``source,target`` pairs made from ``seed``: sources of 4-60 words
    from a made-up lexicon, the target the first 1-20 of them through a
    fixed word-for-word dictionary into a second made-up lexicon."""
    rng = np.random.default_rng(seed)
    words = made_up_words(rng, 2 * T5_LEXICON)
    source_words = np.asarray(words[:T5_LEXICON])
    target_of = dict(zip(words[:T5_LEXICON], words[T5_LEXICON:]))
    lengths = rng.integers(4, 61, rows)
    lines = ["source,target"]
    for i in range(rows):
        source = rng.choice(source_words, lengths[i])
        target = " ".join(target_of[w] for w in source[:20])
        lines.append(f"{quoted_text(i, ' '.join(source), 'translate')},"
                     f'"{target}"')
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def autotune_lookup():
    """(training, decode) crossovers recorded for this card."""
    from tpu_pipelines_torch.ops import autotune

    kind = autotune.current_device_kind(DEVICE)
    return autotune.lookup_crossover(kind), autotune.lookup_decode_crossover(kind)


def t5_dag_phase(seed, card, workdir):
    """The T5-small seq2seq DAG on the card: all six nodes through
    LocalDagRunner(device="cuda") at T5_SMALL with ``attn_impl "auto"``
    (the T5 twin's own default is dense, as the reference's), so the
    decode crossover measured on this card decides the BulkInferrer's
    decode attention; cold then warm; the BulkInferrer beam-decodes the
    raw eval split through the payload's embedded transform.  Returns each
    kernel's launches in the cold run."""
    from tpu_pipelines_torch.components.bulk_inferrer import _shard_batches
    from tpu_pipelines_torch.data import examples_io
    from tpu_pipelines_torch.examples import t5_pipeline
    from tpu_pipelines_torch.trainer.export import model_input_columns

    base = os.path.join(workdir, "t5")
    csv_path = os.path.join(workdir, "pairs.csv")
    pairs_csv(csv_path, seed, T5_DAG_PAIRS)
    hp = {**t5_pipeline.T5_SMALL, "attn_impl": "auto"}
    module_path = os.path.join(t5_pipeline.HERE, "t5_module.py")
    env = {"T5_DATA_CSV": csv_path, "T5_TRAIN_STEPS": str(T5_DAG_STEPS),
           "T5_TINY": ""}

    def run_once():
        from tpu_pipelines_torch.orchestration import LocalDagRunner

        with mock.patch.dict(os.environ, env):
            pipe = t5_pipeline.create_pipeline(base)
        trainer = next(c for c in pipe.components if c.id == "Trainer")
        trainer.exec_properties["hyperparameters"] = hp
        LocalDagRunner(device=DEVICE).run(pipe)

    os.makedirs(base)
    cold, cold_s, _, warm_s, launches, seen = run_dag("t5_dag", run_once,
                                                      module_path)
    print(f"t5_dag nodes [{card}]: {T5_DAG_PAIRS} pairs; cold run "
          f"{cold_s:.1f} s: " + ", ".join(
              f"{k} {v.wall_clock_s:.2f} s" for k, v in cold.nodes.items())
          + f"; warm run {warm_s:.2f} s, all {len(cold.nodes)} CACHED, no "
          "kernel launched", flush=True)
    out = {k: {key: arts[0].uri for key, arts in v.outputs.items()}
           for k, v in cold.nodes.items()}
    raw_uri = out["CsvExampleGen"]["examples"]
    examples_uri = out["Transform"]["transformed_examples"]
    model_uri = out["Trainer"]["model"]

    # Training is dense (T5's self-attention carries a relative bias): no
    # kernel moves until the BulkInferrer, whose beam search launches the
    # decode kernel once per decoder layer and pass, max_decode_len passes
    # a batch (the step-0 pass, then max_decode_len - 1 beam steps).
    trainer_checks("t5_dag", seen, T5_DAG_STEPS)
    if any(seen["after_trainer"].values()):
        raise AssertionError(f"t5_dag: the Trainer launched {seen['after_trainer']}")
    decode_len, batch = hp["max_decode_len"], 64
    shard_rows = examples_io.shard_row_counts(raw_uri, "eval")
    n_batches = sum(-(-r // batch) for r in shard_rows)
    layers = t5m.DEFAULT_HPARAMS["n_layers"]
    # "auto" at the beam step's cache, by the decode crossover recorded for
    # this card.
    impl = tfm.choose_decode_impl(batch * hp["beam_size"],
                                  t5m.DEFAULT_HPARAMS["n_heads"], decode_len,
                                  t5m.DEFAULT_HPARAMS["head_dim"],
                                  torch.device(DEVICE))
    want = {**dict.fromkeys(fa.COUNTERS, 0),
            "decode_launches": layers * decode_len * n_batches
            * (impl == "flash")}
    if launches != want:
        raise AssertionError(f"t5_dag: launches {launches}, expected {want} "
                             f"for auto = {impl}")
    result = seen["result"]
    print(f"t5_dag trainer [{card}]: {result.steps_completed} steps at batch "
          f"{hp['batch_size']}, {result.examples_per_sec:.1f} examples/s, "
          f"losses {seen['losses'][0]:.4f} -> {seen['losses'][-1]:.4f} "
          f"(finite), step 1 eager, {seen['captures']} capture, "
          f"{seen['replays']} replays, compiles after warm-up 0, no attention "
          f"kernel; decode attn_impl auto chose {impl} at {decode_len} keys "
          f"(decode crossover {autotune_lookup()[1]})", flush=True)
    save_seconds("t5_dag", seen, card)

    # One prediction row per eval row, in the input's order: the first
    # batch of the first shard and the last batch of the last, decoded
    # again here from the raw rows, and from the Transform's materialized
    # rows with the payload's generate step alone.
    rows = sum(shard_rows)
    preds = examples_io.read_split(out["BulkInferrer"]["inference_result"],
                                   "eval")["prediction"]
    if preds.shape != (rows, decode_len) or preds.dtype.kind != "i":
        raise AssertionError(f"t5_dag: predictions {preds.shape} {preds.dtype}")
    loaded = load_exported_model(model_uri, device=DEVICE)
    step = t5_module.make_generate_step(loaded.model,
                                        loaded.spec["hyperparameters"])
    columns = model_input_columns(loaded, raw=True)
    last = max(i for i, r in enumerate(shard_rows) if r)
    first_tokens = None
    for shard, where in ((0, "first"), (last, "last")):
        raw = list(_shard_batches(raw_uri, "eval", shard, batch, columns))
        mat = list(_shard_batches(examples_uri, "eval", shard, batch, None))
        raw, mat = (raw[0], mat[0]) if where == "first" else (raw[-1], mat[-1])
        tokens = loaded.generate(raw)
        with torch.inference_mode():
            from_rows = step(loaded.params, mat).cpu().numpy()
        n = len(tokens)
        at = 0 if where == "first" else rows - n
        if not (np.array_equal(tokens, from_rows)
                and np.array_equal(tokens, preds[at:at + n])):
            raise AssertionError(f"t5_dag: the {where} batch differs")
        if where == "first":
            first_tokens, first_rows = tokens, mat
    print(f"t5_dag bulk inference [{card}]: {rows} eval rows in {n_batches} "
          f"batches of up to {batch} x beam {hp['beam_size']}, predictions "
          f"[{rows}, {decode_len}] int; the first and the last batch decoded "
          f"again from raw rows == from the materialized rows == the node's "
          f"rows; flash_decode launches {launches['decode_launches']} = "
          + (f"{layers} layers x {decode_len} passes x {n_batches} batches; "
             if impl == "flash" else "none (auto chose dense); ")
          + 
          f"{rows / cold.nodes['BulkInferrer'].wall_clock_s:.1f} rows/s, "
          f"{generated_tokens(preds) / cold.nodes['BulkInferrer'].wall_clock_s:.1f}"
          f" generated tokens/s (node wall)", flush=True)

    # Teacher-forced logits of the first batch's emitted tokens: the
    # kernel against dense decode attention, and the two controls (only
    # where "auto" put the kernel on this path).
    if impl != "flash":
        print("t5_dag: the payload decodes with dense attention here, so "
              "there is no kernel to hold against it", flush=True)
        return by_record(launches)
    dense = load_exported_model(
        payload_view(model_uri, os.path.join(workdir, "t5_dense"),
                     attn_impl="dense"), device=DEVICE)
    gaps = teacher_forced_gaps(loaded, dense, first_rows["inputs"],
                               first_rows["input_mask"].astype(np.int32),
                               first_tokens, decode_len=decode_len)
    controls = {name: g for name, g in gaps.items() if name != "sound"}
    print(f"t5_dag teacher-forced max |flash - dense| logit over {decode_len} "
          f"steps, {len(first_tokens)} rows = {gaps['sound']:.3e} (tol "
          f"{DECODE_LOGIT_TOL:g}); controls " + ", ".join(
              f"{name} {g:.3e}" for name, g in controls.items())
          + f" (each must exceed {DECODE_LOGIT_TOL:g})", flush=True)
    if gaps["sound"] > DECODE_LOGIT_TOL:
        raise AssertionError("t5_dag: flash-decoded logits disagree with dense")
    if min(controls.values()) <= DECODE_LOGIT_TOL:
        raise AssertionError("t5_dag: a control stays within DECODE_LOGIT_TOL")
    return by_record(launches)


# -------------------------------------------------------------------- fleet

# The serving fleet on the card: BERT-base behind ModelServer(replicas=2,
# max_versions=2, slo_p99_ms=50) with every predict bucket captured as a
# CUDA graph at the swap gate, and T5-small as the generative model type,
# each replica's engine capturing its (batch, kv) step graphs at warm-up.
FLEET_REPLICAS = 2
FLEET_SLO_MS = 50.0
FLEET_BATCH = 32
FLEET_SUPERVISOR_S = 0.2
FLEET_ENGINE_BATCH = 8
FLEET_PAGE = DECODE_LEN // 4
# Token admission bound of the generative fleet: above what 8 clients can
# owe at once (8 x 4 rows x 128 tokens), far below the admission burst.
FLEET_TOKENS = 6144
FLEET_BURST = 32
# Sequences run through two gated engines (captured and eager steps).
FLEET_GATED = 16


def payload_copy(src, dst):
    """A pushed version: the payload's files hard-linked under ``dst``."""
    shutil.copytree(src, dst, copy_function=os.link)


def nan_payload(src, dst):
    """A bad push: ``src``'s payload with its classifier weights NaN."""
    payload_copy(src, dst)
    ckpt = os.path.join(dst, "checkpoint", "state_dict.pt")
    state = torch.load(ckpt, map_location="cpu", weights_only=True)
    os.unlink(ckpt)
    state["head.weight"] = torch.full_like(state["head.weight"], float("nan"))
    torch.save(state, ckpt)


def post_code(url, body=None):
    req = urllib.request.Request(url, data=json.dumps(body or {}).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def wait_for(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet: timed out waiting for {what}")
        time.sleep(0.02)


def eager(loaded, batch):
    """``loaded``'s device step run eagerly on ``batch`` (no graph)."""
    from tpu_pipelines_torch.trainer.export import _to_numpy, on_device

    with torch.inference_mode():
        return _to_numpy(loaded.device_step(loaded.params,
                                            on_device(batch, loaded.device)))


def fleet_predict_phase(seed, n_requests, card, workdir):
    """BERT-base through the predict fleet.  Returns the flash_fwd
    launches of the main client run."""
    from tpu_pipelines_torch.testing import faults

    hp = {**DEFAULT_HPARAMS, "attn_impl": "flash"}
    src = os.path.join(workdir, "bert", "1")
    base = os.path.join(workdir, "fleet_bert")
    payload_copy(src, os.path.join(base, "1"))
    requests = make_requests(np.random.default_rng(seed + 11), n_requests,
                             hp["vocab_size"])
    server = ModelServer("bert", base, replicas=FLEET_REPLICAS,
                         max_versions=2, slo_p99_ms=FLEET_SLO_MS,
                         max_batch_size=FLEET_BATCH,
                         supervisor_interval_s=FLEET_SUPERVISOR_S,
                         device="cuda")
    fleet = server._fleet
    replicas = fleet.pool.replicas
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/bert"
        # Version 1 went active with nothing to warm from: its first batch
        # is its warm-up, one graph per padded bucket captured before that
        # batch is served.  Graph memory: what the card holds after that
        # request beyond before it, each read after a collection with the
        # allocator's free blocks released.
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        warm, _ = run_clients(f"{url}:predict", requests[:1], n_procs=1,
                              threads=1)   # also the fleet's canary batch
        if warm[0][0] != 200:
            raise AssertionError(f"fleet: warm-up answered {warm[0][0]}")
        warm1 = dict(fleet.last_warm or {})
        loaded = fleet.active_loaded()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        graph_bytes = torch.cuda.memory_reserved() - reserved0
        buckets = warm1.get("buckets", [])
        rows = [r for p in requests for r in p["instances"]]
        ids = np.asarray([r["input_ids"] for r in rows])
        mask = np.asarray([r["attention_mask"] for r in rows])

        def unequal_buckets(version):
            """Buckets whose replay differs from the eager step."""
            return [b for b in buckets if not np.array_equal(
                version.predict({"input_ids": ids[:b],
                                 "attention_mask": mask[:b]}),
                eager(version, {"input_ids": ids[:b],
                                "attention_mask": mask[:b]}))]

        unequal = unequal_buckets(loaded)

        zero_counters()
        batches0 = sum(r.batcher.batches_run for r in replicas)
        results, wall_s = run_clients(f"{url}:predict", requests)
        launches = fa.launches
        n_batches = sum(r.batcher.batches_run for r in replicas) - batches0
        after_warm = loaded.aot.compiles_after_warm

        # A hot swap under load: version 2 (the same weights) pushed while
        # the clients run; the canary, then one graph per padded bucket,
        # before it serves.
        payload_copy(src, os.path.join(base, "2"))
        swap = {}

        def hammer():
            swap["results"], _ = run_clients(f"{url}:predict",
                                             requests[:n_requests // 2])

        served0 = sum(r.latency.count for r in replicas)
        clients = threading.Thread(target=hammer)
        clients.start()
        wait_for(lambda: sum(r.latency.count for r in replicas)
                 >= served0 + n_requests // 8, 120, "the swap's traffic")
        swap["reload"] = post_code(f"{url}:reload")
        clients.join()
        warm2 = dict(fleet.last_warm)
        pushed = fleet.active_loaded()
        unequal2 = unequal_buckets(pushed)
        # A bad push: NaN weights, refused at the canary (409).
        nan_payload(src, os.path.join(base, "3"))
        bad = post_code(f"{url}:reload")

        # KILL_REPLICA on replica 0 with the supervisor on.
        plan = faults.FaultPlan({faults.REPLICA_KEY: faults.NodeFault(
            faults.KILL_REPLICA, replica="0")})
        with plan.activate():
            killed, _ = run_clients(f"{url}:predict",
                                    requests[:n_requests // 3])
            wait_for(lambda: replicas[0].generation >= 1
                     and fleet.supervisor.state(replicas[0]) == "healthy",
                     30, "replica 0's rebuild")
            healed, _ = run_clients(f"{url}:predict",
                                    requests[:n_requests // 8])
        health = server.health()
        after_warm_total = server.metrics.get(
            "serving_aot_compiles_after_warm_total").get()
        active = fleet.active_version
        batch32 = {"input_ids": ids[:FLEET_BATCH],
                   "attention_mask": mask[:FLEET_BATCH]}
        replay_ms = profiled(lambda i: loaded.predict(batch32), 20)
        eager_ms = profiled(lambda i: eager(loaded, batch32), 20)
    finally:
        server.stop()

    codes = [c for c, _, _ in results]
    if any(c != 200 for c in codes):
        raise AssertionError(f"fleet: non-200 replies {sorted(set(codes))}")
    served = np.concatenate([np.asarray(reply["predictions"], np.float32)
                             for _, reply, _ in results])
    dense = load_exported_model(os.path.join(workdir, "bert_dense", "1"),
                                device="cuda")

    def predict(model, mask_rows):
        return np.concatenate([
            eager(model, {"input_ids": ids[i:i + 32],
                          "attention_mask": mask_rows[i:i + 32]})
            for i in range(0, len(rows), 32)])

    want = predict(dense, mask)
    max_err = float(np.abs(served - want).max())
    # Controls: the served version's step fed a wrong key mask.
    control_err = {
        name: float(np.abs(predict(loaded, m) - want).max())
        for name, m in (("mask dropped", np.ones_like(mask)),
                        ("mask of the next row", np.roll(mask, 1, axis=0)))}
    del dense, loaded, pushed
    lat_ms = np.array([t for _, _, t in results]) * 1e3
    swap_codes = sorted({c for c, _, _ in swap["results"]})
    kill_codes = sorted({c for c, _, _ in killed + healed})
    print(f"fleet [{card}]: BERT-base bf16 flash, {FLEET_REPLICAS} replicas, "
          f"max_versions 2, slo_p99_ms {FLEET_SLO_MS:g}, buckets {buckets}: "
          f"version 1's first batch captured {warm1.get('compiled')} graphs in "
          f"{warm1.get('seconds', 0.0):.3f} s before it was served "
          f"(fallback_warm {warm1.get('fallback_warm')}); graph memory "
          f"{graph_bytes} bytes (reserved growth across that request)",
          flush=True)
    print(f"fleet [{card}]: {len(requests)} requests ({len(rows)} rows) in "
          f"{n_batches} device batches, {N_CLIENT_PROCS * CLIENT_THREADS} "
          f"concurrent clients; p50 {np.percentile(lat_ms, 50):.2f} ms, p99 "
          f"{np.percentile(lat_ms, 99):.2f} ms; {len(rows) / wall_s:.1f} "
          f"examples/s; flash_fwd launches {launches} = {N_LAYERS} x "
          f"{n_batches} batches expected (credited per replay); compiles "
          f"after warm {after_warm} (serving_aot_compiles_after_warm_total "
          f"{after_warm_total:g})", flush=True)
    print(f"fleet: replay == eager bit for bit at buckets "
          f"{[b for b in buckets if b not in unequal]} of version 1 (unequal: "
          f"{unequal}) and {[b for b in buckets if b not in unequal2]} of "
          f"version 2 (unequal: {unequal2}); max |fleet - dense| logit = "
          f"{max_err:.3e} (tol {LOGIT_TOL:g})", flush=True)
    for name, err in control_err.items():
        print(f"fleet control, {name}: max |flash - dense| logit = {err:.3e} "
              f"(must exceed tol {LOGIT_TOL:g})", flush=True)
    print(f"fleet [{card}]: hot swap to version 2 under load: reload answered "
          f"{swap['reload'][0]}, replies {swap_codes}, the swap's warm-up "
          f"{warm2['seconds']:.3f} s ({warm2['compiled']} graphs, fallback_warm "
          f"{warm2['fallback_warm']}); bad push (NaN weights) answered "
          f"{bad[0]}; active version {active}", flush=True)
    print(f"fleet: KILL_REPLICA on replica 0 ({plan.log}): replies "
          f"{kill_codes}, replica 0 rebuilt (generation "
          f"{replicas[0].generation}), states {health['fleet']['replica_states']}",
          flush=True)
    for name, (wall, traced, busy, _, n_kernels) in (("replayed", replay_ms),
                                                     ("eager", eager_ms)):
        print(f"fleet step [{card}] {name} predict, batch {FLEET_BATCH} x "
              f"{SEQ_LEN}: host wall {wall:.3f} ms ({traced:.3f} ms traced), "
              f"device busy {busy:.3f} ms (idle share {1 - busy / traced:.3f}), "
              f"{n_kernels:.0f} kernels per step", flush=True)
    if (not buckets or warm1["compiled"] != len(buckets)
            or warm1["fallback_warm"]):
        raise AssertionError(f"fleet: version 1's warm-up {warm1}")
    if unequal or unequal2:
        raise AssertionError(f"fleet: replay != eager at buckets {unequal} "
                             f"(version 1), {unequal2} (version 2)")
    if n_batches < 1 or launches != N_LAYERS * n_batches:
        raise AssertionError(
            f"fleet: flash_fwd launched {launches} times for {n_batches} batches")
    if after_warm != 0 or after_warm_total != 0:
        raise AssertionError(f"fleet: {after_warm} compiles after warm")
    if max_err > LOGIT_TOL:
        raise AssertionError("fleet: flash-served logits disagree with dense")
    if min(control_err.values()) <= LOGIT_TOL:
        raise AssertionError("fleet: a wrong key mask stays within LOGIT_TOL")
    if swap["reload"][0] != 200 or swap_codes != [200]:
        raise AssertionError(f"fleet: hot swap {swap['reload']}, {swap_codes}")
    if warm2["compiled"] != len(buckets) or warm2["fallback_warm"]:
        raise AssertionError(f"fleet: version 2's warm-up {warm2}")
    if bad[0] != 409 or active != "2":
        raise AssertionError(f"fleet: bad push answered {bad}, active {active}")
    if kill_codes != [200] or replicas[0].generation < 1:
        raise AssertionError(f"fleet: killed replica: {kill_codes}")
    return launches


def gated_engine_streams(loaded, prompts, budgets, capture):
    """The given sequences through a fresh engine on the card, all queued
    before its first round (one schedule); ``capture`` False keeps every
    step eager.  Returns (streams, the engine, still open)."""
    gate = threading.Event()
    engine = GenerativeEngine(loaded.decode_fns, loaded.params, device="cuda",
                              max_batch_size=FLEET_ENGINE_BATCH,
                              page_size=FLEET_PAGE,
                              fault_hook=lambda: gate.wait(60))
    if not capture:
        engine._capture = lambda *a: None
    engine.warm()
    handles = [engine.submit_nowait(p, max_new_tokens=m)
               for p, m in zip(prompts, budgets)]
    gate.set()
    return [h.wait(600).tolist() for h in handles], engine


def fleet_generate_phase(seed, n_requests, card, workdir):
    """T5-small as the generative model type.  Returns the flash_decode
    launches of the main client run."""
    src = os.path.join(workdir, "t5", "1")
    base = os.path.join(workdir, "fleet_t5")
    payload_copy(src, os.path.join(base, "1"))
    rng = np.random.default_rng(seed + 12)
    requests = t5_requests(rng, n_requests, t5m.DEFAULT_HPARAMS["vocab_size"])
    for r in requests:
        r["params"] = {"max_new_tokens": int(rng.integers(DECODE_LEN // 8,
                                                          DECODE_LEN + 1))}
    burst = [{"inputs": r["inputs"], "params": {"max_new_tokens": DECODE_LEN}}
             for r in t5_requests(rng, FLEET_BURST,
                                  t5m.DEFAULT_HPARAMS["vocab_size"])]
    t0 = time.perf_counter()
    server = ModelServer("t5", base, model_type="generative",
                         replicas=FLEET_REPLICAS,
                         max_batch_size=FLEET_ENGINE_BATCH,
                         decode_page_size=FLEET_PAGE,
                         max_queue_tokens=FLEET_TOKENS, device="cuda")
    load_s = time.perf_counter() - t0
    fleet = server._fleet
    engines = [r._engines["1"] for r in fleet.pool.replicas]
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/t5:generate"
        graphs = [len(e._target.graphs) for e in engines]
        zero_counters()
        results, wall_s = run_clients(url, requests, n_procs=2, threads=4)
        launches = fa.decode_launches
        steps = sum(e.steps_run for e in engines)
        prefills = sum(e.prefills_run for e in engines)
        after_warm = sum(e.compiles_after_warm for e in engines)
        burst_results, _ = run_clients(url, burst, n_procs=2,
                                       threads=FLEET_BURST // 2)
        loaded = fleet.active_loaded()
    finally:
        server.stop()
    codes = sorted({c for c, _, _ in results})
    burst_codes = [c for c, _, _ in burst_results]
    n_buckets = len(engines[0].batch_buckets) * len(engines[0].kv_buckets)
    served = [list(row) for _, reply, _ in results for row in reply["outputs"]]
    # One schedule, two engines: captured steps against eager steps.
    prompts, budgets = [], []
    for r in requests:
        for ids, m in zip(r["inputs"]["inputs"], r["inputs"]["input_mask"]):
            prompts.append(np.asarray(ids)[:int(np.sum(m))])
            budgets.append(r["params"]["max_new_tokens"])
    prompts, budgets = prompts[:FLEET_GATED], budgets[:FLEET_GATED]
    graph_streams, graph_engine = gated_engine_streams(loaded, prompts,
                                                       budgets, True)
    eager_streams, eager_engine = gated_engine_streams(loaded, prompts,
                                                       budgets, False)
    try:
        kv = graph_engine.kv_buckets[-1]
        with torch.inference_mode():
            with torch.cuda.stream(graph_engine._stream):
                replay_ms = profiled(lambda i: graph_engine._step(
                    FLEET_ENGINE_BATCH, kv).cpu(), 20)
            with torch.cuda.stream(eager_engine._stream):
                eager_ms = profiled(lambda i: eager_engine._run_step(
                    eager_engine._target.arena, FLEET_ENGINE_BATCH, kv)[0].cpu(), 20)
    finally:
        graph_engine.close()
        eager_engine.close()
    same_as_fleet = sum(
        s[:len(g)] == g for s, g in zip(served, graph_streams))
    n_tokens = sum(len(s) for s in graph_streams)
    print(f"fleet generative [{card}]: T5-small bf16 flash decode, "
          f"{FLEET_REPLICAS} replicas, engine batch {FLEET_ENGINE_BATCH}, pages "
          f"of {FLEET_PAGE}: {graphs} step graphs captured at warm-up "
          f"({n_buckets} (batch, kv) buckets per engine; load + warm "
          f"{load_s:.2f} s); {len(requests)} :generate requests ({len(served)} "
          f"rows) from 8 clients in {wall_s:.2f} s: {prefills} prefills, "
          f"{steps} steps, {steps / wall_s:.1f} steps/s; replies {codes}; "
          f"compiles after warm {after_warm}", flush=True)
    print(f"fleet generative: flash_decode launches {launches} = {T5_LAYERS} x "
          f"({prefills} prefills + {steps} steps credited per replay) "
          f"expected; captured engine == eager engine on one schedule: "
          f"{graph_streams == eager_streams} ({len(prompts)} streams, "
          f"{n_tokens} tokens); {same_as_fleet} of {len(graph_streams)} fleet rows "
          f"equal the gated engine's (reported only: another schedule); "
          f"admission burst of {FLEET_BURST} x 4-row 128-token requests: "
          f"{burst_codes.count(429)} answered 429, {burst_codes.count(200)} "
          f"200", flush=True)
    for name, (wall, traced, busy, _, n_kernels) in (("replayed", replay_ms),
                                                     ("eager", eager_ms)):
        print(f"fleet engine step [{card}] {name}, bucket "
              f"({FLEET_ENGINE_BATCH}, {kv}): host wall {wall:.3f} ms "
              f"({traced:.3f} ms traced), device busy {busy:.3f} ms (idle "
              f"share {1 - busy / traced:.3f}), {n_kernels:.0f} kernels per "
              f"step", flush=True)
    if graphs != [n_buckets] * FLEET_REPLICAS:
        raise AssertionError(f"fleet generative: graphs captured {graphs}")
    if codes != [200]:
        raise AssertionError(f"fleet generative: replies {codes}")
    if after_warm != 0:
        raise AssertionError(f"fleet generative: {after_warm} compiles after warm")
    if steps < 1 or launches != T5_LAYERS * (prefills + steps):
        raise AssertionError(f"fleet generative: flash_decode launched "
                             f"{launches} times for {prefills} prefills and "
                             f"{steps} steps")
    if graph_streams != eager_streams:
        raise AssertionError("fleet generative: captured engine streams != eager")
    if 429 not in burst_codes or any(c >= 500 for c in burst_codes):
        raise AssertionError(f"fleet generative: burst codes {sorted(set(burst_codes))}")
    return launches


def fleet_phase(seed, n_requests, n_generate, card, workdir):
    return {"flash_fwd": fleet_predict_phase(seed, n_requests, card, workdir),
            "flash_decode": fleet_generate_phase(seed, n_generate, card,
                                                 workdir)}


# ------------------------------------------------------------------- vision

# ResNet-50 at full width (BASELINE configs[2]; resnet_module's
# EXAMPLE_DEFAULTS): 224x224, 1000 classes, batch 256, SGD-Nesterov 0.1/0.9,
# bf16 compute.
VISION_HP = {**resnet_module.EXAMPLE_DEFAULTS}
VISION_WINDOW = 4
# Served logits against the payload's eager predict of the same rows: bf16
# activations, and cuDNN picks its algorithms by batch size, so a served
# bucket and an eager batch of a request's rows sum in other orders and
# flip bf16 roundings now and then; bound relative to the largest logit.
# The train-mode control (batch statistics for the running averages) must
# land far above it.
VISION_SERVE_TOL = 2e-2
VISION_CONTROL_MIN = 0.1
VISION_REQUESTS = 8
VISION_MAX_BATCH = 8
RESNET_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples",
                             "resnet_module.py")
# The ResNet DAG's npz: the twin's synthetic images (resnet_pipeline's
# _ensure_data at 224x224, 10 classes) cut from 2048 rows to this many:
# the ingest's hash split prints every float of a row (150,528 a row) and
# hashes the text column by column, about 0.35 s a row (PERF.md section
# 4).  The twin's batch is cut with them (RESNET_BATCH, 64 by default): the
# hash split's eval share of 128 rows (33) must clear one eval batch under
# drop_remainder.
RESNET_DAG_ROWS = 128
RESNET_DAG_BATCH = 32
RESNET_DAG_SIZE = 224
MNIST_DAG_STEPS = 100
# The reference Evaluator's multiclass metrics.json: {"problem", "slices":
# [{"slice_key", "num_examples", "metrics": {...}}]}.
MULTICLASS_METRICS = ["accuracy", "loss", "macro_f1", "top5_accuracy"]


# Kinds of kernel in a replayed ResNet step, by name (first match wins):
# cuDNN's convolutions (forward, data and weight gradients), cuBLAS's head
# GEMMs, reductions (BatchNorm statistics and their backward), elementwise
# kernels (BatchNorm's normalization and its backward, the f32/bf16 casts,
# ReLU, the residual adds, the SGD update), the max-pool.
VISION_KERNEL_KINDS = (
    ("conv", r"cudnn|cutlass|xmma|implicit_gemm|conv|wgrad|dgrad|fprop"),
    ("gemm", r"gemm|cublas"),
    ("reduce", r"reduce_kernel"),
    ("elementwise", r"elementwise|foreach"),
    ("max_pool", r"max_pool"),
)


def vision_batches(seed, n):
    """``n`` batches of VISION_HP's NHWC f32 images and integer labels from
    ``seed``."""
    rng = np.random.default_rng(seed + 23)
    batch, size = VISION_HP["batch_size"], VISION_HP["image_size"]
    return [{"image": rng.standard_normal((batch, size, size, 3), np.float32),
             "label": rng.integers(0, VISION_HP["num_classes"],
                                   size=batch).astype(np.int64)}
            for _ in range(n)]


def bn_buffers(model):
    return [b for name, b in model.named_buffers() if "running" in name]


def bn_state_loss_fn(model, batch, generator):
    """resnet_module.loss_fn plus one more metric, ``bn_state``: the sum of
    every running mean and variance after the step's forward."""
    loss, metrics = resnet_module.loss_fn(model, batch, generator)
    state = torch.stack([b.sum() for b in bn_buffers(model)]).sum()
    return loss, {**metrics, "bn_state": state}


def vision_init(seed):
    return init_resnet_weights(build_resnet_model(VISION_HP),
                               torch.Generator().manual_seed(seed))


def vision_run(seed, batches, loss_fn=resnet_module.loss_fn, count=False):
    """train_loop(has_model_state=True) over ``batches``, windows of
    VISION_WINDOW (with ``count``, the loop's counted FLOPs and MFU after
    its timed steps); returns (model, result, per-step metrics, the SGD,
    {captures, replays}, peak device bytes)."""
    metrics, optimizers = [], []
    calls = {"captures": 0, "replays": 0}

    def optimizer(params):
        optimizers.append(resnet_module.sgd(VISION_HP["learning_rate"],
                                            VISION_HP["momentum"])(params))
        return optimizers[-1]

    def counted(name, method):
        def wrapper(self, *args, **kwargs):
            calls[name] += 1
            return method(self, *args, **kwargs)
        return wrapper

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graph = torch.cuda.CUDAGraph
    with mock.patch.object(graph, "replay", counted("replays", graph.replay)), \
            mock.patch.object(graph, "capture_begin",
                              counted("captures", graph.capture_begin)):
        model, result = train_loop(
            loss_fn=loss_fn,
            init_params_fn=lambda generator, sample: init_resnet_weights(
                build_resnet_model(VISION_HP), generator),
            optimizer=optimizer,
            train_iter=iter(batches),
            config=TrainLoopConfig(
                train_steps=len(batches), batch_size=len(batches[0]["label"]),
                log_every=1, window_steps=VISION_WINDOW,
                anchor_every=VISION_WINDOW, seed=seed,
                collect_cost_analysis=count),
            metrics_cb=lambda step, m: metrics.append(m),
            has_model_state=True,
            device=DEVICE,
        )
    torch.cuda.synchronize()
    return (model, result, metrics, optimizers[0], calls,
            torch.cuda.max_memory_allocated())


def vision_eager(seed, batches):
    """The steps of ``vision_run(seed, batches, bn_state_loss_fn)`` written
    out eagerly: (model, SGD, per-step metrics,
    steps at which some BatchNorm buffer did not move, examples/s after the
    first window)."""
    gc.collect()
    torch.cuda.empty_cache()
    model = vision_init(seed).to(DEVICE).train()
    opt = resnet_module.sgd(VISION_HP["learning_rate"],
                            VISION_HP["momentum"])(model.parameters())
    metrics, unmoved = [], []
    before = [b.clone() for b in bn_buffers(model)]
    for s, batch in enumerate(batches):
        if s == VISION_WINDOW:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        dev = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
        loss, m = bn_state_loss_fn(model, dev, None)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        metrics.append({"loss": loss.detach(), **m})
        after = bn_buffers(model)
        if any(torch.equal(a, b) for a, b in zip(after, before)):
            unmoved.append(s + 1)
        before = [b.clone() for b in after]
    torch.cuda.synchronize()
    eps = ((len(batches) - VISION_WINDOW) * len(batches[0]["label"])
           / (time.perf_counter() - t0))
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    return model, opt, metrics, unmoved, eps


def model_flops(model, size):
    """Training FLOPs of one image from the layer shapes: 2 x the MACs of
    every conv (out channels x out H x out W x in channels x k x k) and
    dense layer (in x out), x 3 for the forward and the two backward
    products."""
    macs = []

    def hook(module, inp, out):
        if isinstance(module, torch.nn.Linear):
            macs.append(module.in_features * module.out_features)
        else:
            w = module.weight
            macs.append(out.shape[1] * out.shape[2] * out.shape[3]
                        * w.shape[1] * w.shape[2] * w.shape[3])

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(1, size, size, 3, device=DEVICE))
    finally:
        for h in handles:
            h.remove()
        model.train()
    return 3 * 2 * sum(macs), len(macs)


def vision_replay_breakdown(seed, batch, iters=3):
    """The train loop's step object on one batch (first step eager, the
    capture, then windows of VISION_WINDOW replays, one synchronize each),
    profiled: (wall_ms, profiled wall_ms, busy_ms, kernels) per step, the
    ten kernels with the most device time, (name, ms per step), and the
    device ms per step of each VISION_KERNEL_KINDS kind."""
    model = vision_init(seed).to(DEVICE).train()
    state = TrainState(step=0, model=model, seed=seed,
                       optimizer=resnet_module.sgd(VISION_HP["learning_rate"])(
                           model.parameters()))
    runner = _TrainStep(state, resnet_module.loss_fn, torch.device(DEVICE),
                        torch.cuda.Stream(DEVICE))
    dev = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    runner.run(dev, 0)

    def window(i):
        for j in range(VISION_WINDOW):
            runner.run(dev, 1 + i * VISION_WINDOW + j)
        torch.cuda.synchronize()

    wall_ms, profiled_ms, busy_ms, by_name, n_kernels = profiled(window, iters)
    steps = iters * VISION_WINDOW
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    kinds = {}
    for kernel, us in by_name.items():
        kind = next((k for k, pattern in VISION_KERNEL_KINDS
                     if re.search(pattern, kernel)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + us / steps / 1e3
    return (wall_ms / VISION_WINDOW, profiled_ms / VISION_WINDOW,
            busy_ms / VISION_WINDOW, n_kernels / VISION_WINDOW,
            [(kernel, us / steps / 1e3) for kernel, us in top], kinds)


def train_mode_logits(model, params, images):
    """``model`` on ``images`` with train-mode BatchNorm (batch statistics)
    and ``params``, its running buffers cloned so nothing moves."""
    params = {k: (v.clone() if "running" in k else v) for k, v in params.items()}
    model.train()
    try:
        with torch.no_grad():
            return torch.func.functional_call(
                model, params, (torch.as_tensor(images, device=DEVICE),))
    finally:
        model.eval()


def vision_train_phase(seed, n_steps, card, workdir):
    """ResNet-50 at full width through train_loop(has_model_state=True):
    one capture, replay == eager bit for bit (parameters, momentum buffers,
    running statistics), the statistics moving every step, eval on the
    running averages against train-mode BatchNorm.  Exports the timed
    run's model for vision_serving; returns the payload's directory."""
    batches = vision_batches(seed, n_steps)
    model, result, _, opt, calls, peak_bytes = vision_run(seed, batches,
                                                          count=True)
    flops, layers = model_flops(model, VISION_HP["image_size"])
    counted_ratio = (result.cost_analysis_flops_per_step
                     / (flops * VISION_HP["batch_size"]))
    payload = export_model(
        serving_model_dir=os.path.join(workdir, "resnet", "1"),
        params=model.state_dict(), module_file=RESNET_MODULE,
        hyperparameters=VISION_HP, extra_spec={"label": "label"})
    del model, opt

    # Replay against eager, cuDNN held to deterministic algorithms on both
    # sides (its default may pick one that adds with atomics).
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        g_model, g_result, g_metrics, g_opt, g_calls, _ = vision_run(
            seed, batches, loss_fn=bn_state_loss_fn)
        g_state = {k: v.clone() for k, v in g_model.state_dict().items()}
        g_moms = [g_opt.state[p]["momentum_buffer"].clone()
                  for p in g_model.parameters()]
        images = batches[0]["image"][:32]
        with torch.no_grad():
            eval_logits = g_model.eval()(torch.as_tensor(images, device=DEVICE))
        train_logits = train_mode_logits(g_model, dict(g_model.state_dict()),
                                         images)
        control = float((train_logits - eval_logits).abs().max()
                        / eval_logits.abs().max())
        del g_model, g_opt
        e_model, e_opt, e_metrics, unmoved, eager_eps = vision_eager(seed, batches)
        e_state = e_model.state_dict()
        e_moms = [e_opt.state[p]["momentum_buffer"] for p in e_model.parameters()]
        unequal = [k for k, v in e_state.items() if not torch.equal(v, g_state[k])]
        moms_equal = all(torch.equal(a, b) for a, b in zip(g_moms, e_moms))
        n_buffers = sum(1 for k in e_state if "running" in k)
        del e_model, e_opt, e_state, e_moms, g_moms, g_state
    finally:
        torch.backends.cudnn.deterministic = deterministic
    states = [m["bn_state"] for m in g_metrics]
    moved = all(a != b for a, b in zip(states, states[1:]))
    losses = [m["loss"] for m in g_metrics]
    metrics_equal = g_metrics == e_metrics
    wall_ms, profiled_ms, busy_ms, n_kernels, top, kinds = (
        vision_replay_breakdown(seed, batches[0]))
    peak = _peak_flops_per_chip(DEVICE)
    eps = result.anchored_examples_per_sec_per_chip
    mfu = flops * eps / peak if peak else None

    print(f"vision_train [{card}]: ResNet-{VISION_HP['depth']} (width "
          f"{VISION_HP['width']}, {VISION_HP['num_classes']} classes, "
          f"{VISION_HP['image_size']}x{VISION_HP['image_size']}) bf16, batch "
          f"{VISION_HP['batch_size']}, SGD-Nesterov {VISION_HP['learning_rate']:g}"
          f"/{VISION_HP['momentum']:g}, {result.steps_completed} steps in windows "
          f"of {result.window_steps}: {calls['captures']} capture, "
          f"{calls['replays']} replays, compiles after warm "
          f"{result.compiles_after_warm}", flush=True)
    print("vision_train losses: " + " ".join(f"{x:.5f}" for x in losses),
          flush=True)
    print(f"vision_train throughput [{card}]: {eps} examples/s/chip anchored over "
          f"{result.anchor_windows} windows ({result.examples_per_sec_per_chip} "
          f"whole-run; deterministic cuDNN "
          f"{g_result.anchored_examples_per_sec_per_chip}; eager "
          f"{eager_eps:.2f}); MFU "
          f"{'not measured' if mfu is None else f'{mfu:.4f}'} ({flops} FLOP an "
          f"example from {layers} conv and dense layer shapes, x3 for training, "
          f"against {peak:g} FLOP/s); MFU from the loop {result.mfu} (counted "
          f"{result.cost_analysis_flops_per_step:.6g} FLOP a step, "
          f"{counted_ratio:.4f} of the layer-shape figure); peak device "
          f"memory {peak_bytes} bytes", flush=True)
    print(f"vision_train step [{card}] graph replay, batch "
          f"{VISION_HP['batch_size']}, windows of {VISION_WINDOW} replays: host "
          f"wall {wall_ms:.3f} ms ({profiled_ms:.3f} ms traced), device busy "
          f"{busy_ms:.3f} ms traced (idle share {1 - busy_ms / profiled_ms:.3f}), "
          f"{n_kernels:.0f} kernels per step; device ms per step by kind: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
              kinds.items(), key=lambda kv: -kv[1])), flush=True)
    for kernel, ms in top:
        print(f"vision_train step top kernel: {ms:.3f} ms/step {kernel[:110]}",
              flush=True)
    print(f"vision_train graph vs eager (deterministic cuDNN): losses and "
          f"bn_state {'equal' if metrics_equal else 'DIFFER'} bit for bit; "
          f"{len(unequal)} of the state dict's tensors differ (parameters and "
          f"{n_buffers} running buffers); momentum buffers "
          f"{'equal' if moms_equal else 'DIFFER'}; running statistics moved at "
          f"every step: graph {moved}, eager unmoved at steps {unmoved}; control: "
          f"train-mode BatchNorm vs eval on the running averages, max rel logit "
          f"gap {control:.3e} (must exceed {VISION_CONTROL_MIN:g})", flush=True)

    if (calls != {"captures": 1, "replays": n_steps - 1}
            or result.compiles_after_warm != 0
            or g_calls != calls or not np.isfinite(losses).all()):
        raise AssertionError(f"vision_train: {calls}, {g_calls}, compiles after "
                             f"warm {result.compiles_after_warm}, losses {losses}")
    if not metrics_equal or unequal or not moms_equal:
        raise AssertionError(f"vision_train: the graph run differs from eager: "
                             f"{unequal[:8]}, momentum equal {moms_equal}")
    if not moved or unmoved:
        raise AssertionError(f"vision_train: running statistics did not move at "
                             f"every step: {states}, eager unmoved {unmoved}")
    if not control > VISION_CONTROL_MIN:
        raise AssertionError("vision_train: eval on the running averages equals "
                             "train-mode BatchNorm: the control cannot tell")
    if result.mfu is None or abs(counted_ratio - 1) > TUNE_FLOP_TOL:
        raise AssertionError(f"vision_train: MFU from the loop {result.mfu}, "
                             f"counted/analytic FLOPs {counted_ratio}")
    return payload


def vision_serving_phase(seed, card, workdir, payload):
    """The exported ResNet-50 served from its bucket graphs on the running
    averages."""
    base = os.path.dirname(payload)
    size = VISION_HP["image_size"]
    rng = np.random.default_rng(seed + 29)
    requests = [{"instances": [
        {"image": rng.standard_normal(size * size * 3).astype(np.float32).tolist()}
        for _ in range(int(rng.integers(1, 5)))]} for _ in range(VISION_REQUESTS)]
    server = ModelServer("resnet", base, replicas=1, max_versions=2,
                         max_batch_size=VISION_MAX_BATCH, device=DEVICE)
    fleet = server._fleet
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/resnet:predict"
        t0 = time.perf_counter()
        first, _ = run_clients(url, requests[:1], n_procs=1, threads=1)
        first_s = time.perf_counter() - t0
        warm = dict(fleet.last_warm or {})
        loaded = fleet.active_loaded()
        entries_at_first = len(loaded.aot.entries)
        results, wall_s = run_clients(url, requests, n_procs=2, threads=4)
        after_warm = loaded.aot.compiles_after_warm
    finally:
        server.stop()
    codes = [first[0][0]] + [c for c, _, _ in results]
    if any(c != 200 for c in codes):
        raise AssertionError(f"vision_serving: replies {codes}")
    rows = [np.asarray([r["image"] for r in p["instances"]], np.float32)
            for p in requests]
    served = [np.asarray(reply["predictions"], np.float32)
              for _, reply, _ in results]
    want = [eager(loaded, {"image": r}) for r in rows]
    scale = max(float(np.abs(w).max()) for w in want)
    err = max(float(np.abs(s - w).max()) for s, w in zip(served, want)) / scale
    control = max(float(np.abs(train_mode_logits(
        loaded.model, loaded.params, r.reshape(-1, size, size, 3)
    ).cpu().numpy() - w).max()) for r, w in zip(rows, want)) / scale
    n_rows = sum(len(r) for r in rows)
    lat_ms = np.array([t for _, _, t in results]) * 1e3
    print(f"vision_serving [{card}]: ResNet-{VISION_HP['depth']} payload behind "
          f"ModelServer(replicas=1, max_versions=2, max_batch_size="
          f"{VISION_MAX_BATCH}); first request {first_s:.2f} s (canary and "
          f"warm-up: {warm.get('compiled')} bucket graphs {warm.get('buckets')} "
          f"captured before it was served, {entries_at_first} installed); "
          f"{len(requests)} requests ({n_rows} rows of {size}x{size}x3) all 200 "
          f"in {wall_s:.2f} s, p50 {np.percentile(lat_ms, 50):.1f} ms, slowest "
          f"{lat_ms.max():.1f} ms, compiles after warm {after_warm}; max |served "
          f"- eager| = {err:.3e} of the largest logit (tol {VISION_SERVE_TOL:g}); "
          f"control, train-mode BatchNorm: {control:.3e} (must exceed "
          f"{VISION_CONTROL_MIN:g})", flush=True)
    buckets = warm.get("buckets") or []
    if (not buckets or warm.get("compiled") != len(buckets)
            or warm.get("fallback_warm") or entries_at_first < len(buckets)
            or after_warm != 0):
        raise AssertionError(f"vision_serving: warm-up {warm}, {entries_at_first} "
                             f"entries, {after_warm} compiles after warm")
    if any(s.shape != (len(r), VISION_HP["num_classes"]) or not np.isfinite(s).all()
           for s, r in zip(served, rows)):
        raise AssertionError("vision_serving: reply shapes or values")
    if err > VISION_SERVE_TOL:
        raise AssertionError("vision_serving: served logits disagree with eager")
    if not control > VISION_CONTROL_MIN:
        raise AssertionError("vision_serving: train-mode BatchNorm stays close: "
                             "the check cannot tell the running averages")


def resnet_npz(path, rows):
    """The ResNet twin's synthetic npz at 224x224 and 10 classes (its
    _ensure_data's draws), cut to its first ``rows`` rows."""
    rng = np.random.default_rng(0)
    n, classes = 2048, 10
    labels = rng.integers(0, classes, size=n)[:rows]
    # The generator fills row by row: the first rows of the twin's draw.
    images = (labels[:, None, None, None] / classes + 0.1 * rng.normal(
        size=(rows, RESNET_DAG_SIZE, RESNET_DAG_SIZE, 3))).astype(np.float32)
    np.savez(path, image=images.reshape(rows, -1),
             label=labels.astype(np.int64))
    return path


def vision_dag_phase(name, seed, card, workdir):
    """The MNIST or ResNet twin through ``python -m tpu_pipelines_torch run
    --pipeline-module`` (in this process), cold then warm, read back with
    ``trace latest``.  Returns the node walls."""
    from tpu_pipelines_torch.examples import mnist_pipeline, resnet_pipeline

    twin = {"mnist": mnist_pipeline, "resnet": resnet_pipeline}[name]
    base = os.path.join(workdir, name)
    os.makedirs(base)
    env = {"TPP_PIPELINE_HOME": base}
    if name == "mnist":
        env.update(MNIST_NPZ="", MNIST_TRAIN_STEPS=str(MNIST_DAG_STEPS))
        steps = MNIST_DAG_STEPS
    else:
        t0 = time.perf_counter()
        npz = resnet_npz(os.path.join(workdir, "images_224_c10.npz"),
                         RESNET_DAG_ROWS)
        print(f"resnet_dag data: {RESNET_DAG_ROWS} rows of "
              f"{RESNET_DAG_SIZE * RESNET_DAG_SIZE * 3} float32 "
              f"({os.path.getsize(npz)} bytes) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        env.update(RESNET_NPZ=npz, RESNET_DEPTH="50",
                   RESNET_IMAGE_SIZE=str(RESNET_DAG_SIZE),
                   RESNET_BATCH=str(RESNET_DAG_BATCH))
        steps = 60  # the twin's defaults: 60 steps, 10 classes
    pipeline_module = os.path.join(twin.HERE, f"{name}_pipeline.py")
    root = os.path.join(base, "root")
    traces, allocs = {}, {}

    def run_once():
        with mock.patch.dict(os.environ, env):
            code, out = cli(["run", "--pipeline-module", pipeline_module,
                             "--device", DEVICE])
        if code != 0:
            raise AssertionError(f"{name}_dag: run exited {code}: {out[-2000:]}")

    def after_run(tag):
        # Allocations the card's caching allocator has served so far: a run
        # with no device work adds none.
        allocs[tag] = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
        traces[tag] = traced_run(f"{name}_dag", root,
                                 0.0 if tag == "cold" else 1.0, workdir,
                                 f"{name}_{tag}")

    cold, cold_s, warm, warm_s, launches, seen = run_dag(
        f"{name}_dag", run_once, os.path.join(twin.HERE, f"{name}_module.py"),
        after_run=after_run)
    trainer_checks(f"{name}_dag", seen, steps)
    if any(launches.values()):
        raise AssertionError(f"{name}_dag: an attention kernel launched {launches}")
    if allocs["warm"] != allocs["cold"]:
        raise AssertionError(f"{name}_dag: the warm run worked the card: "
                             f"{allocs['warm'] - allocs['cold']} allocations")
    out = {k: {key: arts[0].uri for key, arts in v.outputs.items()}
           for k, v in cold.nodes.items()}
    loaded = load_exported_model(out["Trainer"]["model"], device=DEVICE)
    buffers = {k: v for k, v in loaded.params.items() if "running" in k}
    if name == "resnet":
        n_bn = sum(1 for m in loaded.model.modules()
                   if type(m).__name__ == "BatchNorm")
        still = [k for k, v in buffers.items() if torch.equal(
            v, torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v))]
        if len(buffers) != 2 * n_bn or still or n_bn != 53:
            raise AssertionError(f"{name}_dag: payload buffers {len(buffers)} for "
                                 f"{n_bn} BatchNorms, unmoved {still[:4]}")
    with open(os.path.join(out["Evaluator"]["evaluation"], "metrics.json")) as f:
        metrics = json.load(f)
    keys = sorted(metrics["slices"][0]["metrics"])
    if (sorted(metrics) != ["problem", "slices"]
            or metrics["problem"] != "multiclass" or keys != MULTICLASS_METRICS):
        raise AssertionError(f"{name}_dag: metrics.json {metrics}")
    props = node_props(base, cold)
    result = seen["result"]
    ingest = props["ImportExampleGen"]
    print(f"{name}_dag nodes [{card}]: `python -m tpu_pipelines_torch run` cold "
          f"{cold_s:.1f} s: " + ", ".join(
              f"{k} {v.wall_clock_s:.2f} s" for k, v in cold.nodes.items())
          + f"; warm run {warm_s:.2f} s, all {len(cold.nodes)} CACHED, no "
          f"allocation on the card; ingest {ingest.get('num_examples')} rows at "
          f"{ingest.get('ingest_rows_per_sec')} rows/s", flush=True)
    print(f"{name}_dag trainer [{card}]: {result.steps_completed} steps, "
          f"{result.examples_per_sec:.1f} examples/s over the run, losses "
          f"{seen['losses'][0]:.4f} -> {seen['losses'][-1]:.4f}, step 1 eager, "
          f"{seen['captures']} capture, {seen['replays']} replays, compiles after "
          f"warm-up 0; payload: {len(buffers)} running buffers; Evaluator "
          f"{json.dumps(metrics['slices'][0]['metrics'])} over "
          f"{metrics['slices'][0]['num_examples']} rows; trace: "
          f"{len(traces['cold']['per_node'])} node spans, critical path "
          f"{' -> '.join(traces['cold']['critical_path_nodes'])}, cache hit "
          f"ratio {traces['cold']['cache_hit_ratio']} cold, "
          f"{traces['warm']['cache_hit_ratio']} warm", flush=True)
    save_seconds(f"{name}_dag", seen, card)
    return {k: v.wall_clock_s for k, v in cold.nodes.items()}



# ---- tune_rewrite: search, the trainer's extras, rewriting, the int8 fleet

TUNE_ROWS = 8000
TUNE_LRS = [1e-4, 1e-5]
# Successive halving with eta 2: the four rates at 10 steps, the best two
# at 20 (the full budget).
TUNE_RUNGS = (10, 20)
TUNE_STEPS = 40
# Profiled steps [from, to) of the Trainer (the reference's defaults).
TUNE_PROFILE = (2, 5)
# Heartbeats land once per window: the timeout must exceed the first
# window's wall, its capture included.
TUNE_STALL_S = 300.0
# An in-process trial returns the card's allocated bytes to within this of
# their value before it (a kept graph pool would hold gigabytes).
TUNE_MEM_MARGIN = 64 << 20
# Counted FLOPs a step against the analytic figure (BERT-base and
# ResNet-50): the analytic one counts the pooler and head at every token
# and the first layer's input gradient, which the count does not.
TUNE_FLOP_TOL = 0.05
# The int8 payload's resident parameter bytes against the float32 one's.
INT8_BYTES_MAX = 0.3
# Logits of the int8 payload against the float32 payload's on the same
# transformed rows, relative to the largest float32 logit (per-channel
# weight-only int8); the control (the int8 payload with every attention
# mask dropped) must miss it.
INT8_LOGIT_TOL = 5e-2
TUNE_REQUESTS = 32
TUNE_PIPELINE = """\\
import json
import os

from tpu_pipelines_torch.components import (
    CsvExampleGen, Evaluator, Pusher, Rewriter, SchemaGen, StatisticsGen,
    Trainer, Transform, Tuner,
)
from tpu_pipelines_torch.dsl.pipeline import Pipeline


def create_pipeline():
    env = os.environ
    base = env["TUNE_HOME"]
    hp = json.loads(env["TUNE_HPARAMS"])
    rungs = json.loads(env["TUNE_RUNGS"])
    lrs = json.loads(env["TUNE_LRS"])
    gen = CsvExampleGen(input_path=env["TUNE_DATA"])
    stats = StatisticsGen(examples=gen.outputs["examples"])
    schema = SchemaGen(statistics=stats.outputs["statistics"])
    transform = Transform(
        examples=gen.outputs["examples"], schema=schema.outputs["schema"],
        module_file=env["TUNE_PREPROCESSING"],
    )
    examples = transform.outputs["transformed_examples"]
    graph = transform.outputs["transform_graph"]
    tuner = Tuner(
        examples=examples, transform_graph=graph,
        module_file=env["TUNE_MODULE"],
        search_space={"learning_rate": lrs}, algorithm="halving",
        max_trials=len(lrs), halving_eta=2, min_train_steps=rungs[0],
        train_steps=rungs[1], base_hyperparameters=hp,
        custom_config={"train_loop": {"checkpoint_every": 0}},
    )
    # The same search machinery with its trial in a child process.
    isolated = Tuner(
        examples=examples, transform_graph=graph,
        module_file=env["TUNE_MODULE"],
        search_space={"learning_rate": lrs[:1]}, algorithm="halving",
        max_trials=1, halving_eta=2, min_train_steps=rungs[0],
        train_steps=rungs[0], base_hyperparameters=hp,
        custom_config={"train_loop": {"checkpoint_every": 0}},
        isolate_trials=True,
    ).with_id("TunerIsolated")
    trainer = Trainer(
        examples=examples, transform_graph=graph,
        hyperparameters=tuner.outputs["best_hyperparameters"],
        module_file=env["TUNE_MODULE"], train_steps=int(env["TUNE_STEPS"]),
        custom_config={"train_loop": json.loads(env["TUNE_LOOP"])},
    )
    evaluator = Evaluator(
        examples=examples, model=trainer.outputs["model"],
        label_key="label", problem="multiclass",
        batch_size=int(hp["batch_size"]),
    )
    rewriter = Rewriter(
        model=trainer.outputs["model"], examples=examples,
        transform_graph=graph, variants=["bfloat16", "aqt_int8"],
        quality_metrics=["accuracy"], label_key="label",
        problem="multiclass", batch_size=int(hp["batch_size"]),
        max_eval_examples=1024, latency_batch_size=32, latency_iters=20,
    )
    pusher = Pusher(
        model=rewriter.outputs["model"], blessing=evaluator.outputs["blessing"],
        push_destination=env["TUNE_PUSH"], variant="aqt_int8",
    )
    return Pipeline(
        "bert-tune-rewrite",
        [gen, stats, schema, transform, tuner, isolated, trainer, evaluator,
         rewriter, pusher],
        pipeline_root=os.path.join(base, "root"),
        metadata_path=os.path.join(base, "metadata.sqlite"),
    )
"""


def _varint_at(buf, i):
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, i


def _fields(buf):
    """(field number, wire type, value) of one protobuf message."""
    import struct

    i = 0
    while i < len(buf):
        key, i = _varint_at(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint_at(buf, i)
        elif wire == 1:
            value, i = struct.unpack_from("<d", buf, i)[0], i + 8
        elif wire == 5:
            value, i = struct.unpack_from("<f", buf, i)[0], i + 4
        elif wire == 2:
            n, i = _varint_at(buf, i)
            value, i = bytes(buf[i:i + n]), i + n
        else:
            raise ValueError(f"event file: wire type {wire}")
        yield num, wire, value


def read_event_scalars(logdir):
    """``{tag: [(step, value)]}`` from every ``events.out.tfevents.*`` file
    under ``logdir``: TFRecord framing (lengths and masked crcs not
    checked here), ``Event{step = 2, summary = 5}``, ``Summary{value = 1}``,
    ``Value{tag = 1, simple_value = 2}``; the card's machine has no
    TensorBoard to read them."""
    import struct

    out = {}
    for name in sorted(os.listdir(logdir)):
        if not name.startswith("events.out.tfevents."):
            continue
        data = open(os.path.join(logdir, name), "rb").read()
        i = 0
        while i < len(data):
            (n,) = struct.unpack_from("<Q", data, i)
            record = data[i + 12:i + 12 + n]
            i += 16 + n
            step, values = 0, []
            for num, _, value in _fields(record):
                if num == 2:
                    step = value
                elif num == 5:
                    for vnum, _, v in _fields(value):
                        if vnum == 1:
                            tag = val = None
                            for fnum, _, x in _fields(v):
                                if fnum == 1:
                                    tag = x.decode()
                                elif fnum == 2:
                                    val = x
                            values.append((tag, val))
            for tag, val in values:
                out.setdefault(tag, []).append((step, val))
    return out


def profile_kernel_counts(path, names):
    """How many device kernels of each of ``names`` a Chrome trace holds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {n: sum(n in k for k in kernels) for n in names}, len(kernels)


def bert_shape(model):
    """(matmul parameters, layers, d_model) of a BERT model."""
    n = sum(p.numel() for name, p in model.named_parameters()
            if not re.search(r"(embed|pos_embed|type_embed)\.weight$", name))
    return n, len(model.encoder.layers), model.encoder.embed.weight.shape[1]


def bert_flops(shape, batch, length):
    """bench.py's analytic FLOPs of one BERT training step (the training
    phase's): 6 N T over the matmul parameters plus the attention's
    12 x layers x B x L^2 x d_model."""
    n, layers, d = shape
    return 6 * n * batch * length + 12 * layers * batch * length ** 2 * d


def served_batches(fleet):
    """Device batches the fleet's replicas have run."""
    return sum(r.batcher.batches_run for r in fleet.pool.replicas)


def served_p50(url, requests, fleet):
    """Median client latency of ``requests`` posted one after another,
    after one untimed request, and the attention launches and device
    batches of the timed requests alone."""
    def post(body):
        req = urllib.request.Request(url, data=json.dumps(body).encode())
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            r.read()
            if r.status != 200:
                raise AssertionError(f"tune_rewrite: {url} answered {r.status}")
        return (time.perf_counter() - t0) * 1e3

    post(requests[0])
    zero_counters()
    batches0 = served_batches(fleet)
    p50 = float(np.median([post(body) for body in requests]))
    return p50, counters(), served_batches(fleet) - batches0


def check_served_launches(name, launches, n_batches):
    """A fleet's served requests launched the forward 12 x its device
    batches (credited per replay) and no other kernel."""
    want = {k: 0 for k in fa.COUNTERS}
    want["launches"] = N_LAYERS * n_batches
    if n_batches < 1 or launches != want:
        raise AssertionError(f"{name}: the fleet launched {launches} for "
                             f"{n_batches} device batches")


def tune_rewrite_phase(seed, card, workdir):
    """A Tuner picks BERT-base's learning rate, the Trainer trains on it
    with a profile, TensorBoard scalars, counted FLOPs, MFU, goodput and
    a stall watchdog, the Rewriter emits bf16 and int8 variants behind its
    quality gate, the Pusher pushes the int8 one, and a fleet serves it
    from bucket graphs.  Returns each kernel's launches in the phase."""
    import importlib

    from tpu_pipelines_torch.components import tuner as tuner_mod
    from tpu_pipelines_torch.components.rewriter import variant_dirs
    from tpu_pipelines_torch.data.input_pipeline import BatchIterator, InputConfig
    from tpu_pipelines_torch.examples import bert_pipeline
    from tpu_pipelines_torch.trainer import goodput as gp
    from tpu_pipelines_torch.trainer import quantize as qz
    from tpu_pipelines_torch.utils.module_loader import load_module

    base = os.path.join(workdir, "tune")
    os.makedirs(base)
    csv_path = os.path.join(workdir, "tune_reviews.csv")
    reviews_csv(csv_path, seed, TUNE_ROWS)
    module_path = os.path.join(bert_pipeline.HERE, "bert_module.py")
    pipeline_path = os.path.join(workdir, "tune_pipeline.py")
    with open(pipeline_path, "w") as f:
        f.write(TUNE_PIPELINE)
    hp = dict(bert_pipeline.BERT_BASE)
    push = os.path.join(base, "push")
    loop_options = {
        "profile_dir": os.path.join(base, "profile"),
        "profile_from": TUNE_PROFILE[0], "profile_to": TUNE_PROFILE[1],
        "tensorboard_dir": os.path.join(base, "tensorboard"),
        "collect_cost_analysis": True, "stall_timeout_s": TUNE_STALL_S,
    }
    env = {"TUNE_HOME": base, "TUNE_DATA": csv_path,
           "TUNE_HPARAMS": json.dumps(hp), "TUNE_RUNGS": json.dumps(TUNE_RUNGS),
           "TUNE_LRS": json.dumps(TUNE_LRS), "TUNE_STEPS": str(TUNE_STEPS),
           "TUNE_MODULE": module_path, "TUNE_PUSH": push,
           "TUNE_LOOP": json.dumps(loop_options),
           "TUNE_PREPROCESSING": os.path.join(bert_pipeline.HERE,
                                              "bert_preprocessing.py")}

    # Each train_loop call of the module (the trials' and the Trainer's),
    # and the wall of each step of the Trainer's (its windows are one step).
    user = load_module(module_path)
    loop_module = importlib.import_module("tpu_pipelines_torch.trainer.train_loop")
    calls, step_walls = [], []
    real_loop, real_run = user.train_loop, loop_module._TrainStep.run

    def loop(**kw):
        model, result = real_loop(**kw)
        calls.append((kw["config"], result, bert_shape(model)))
        return model, result

    def timed_run(self, batch, step):
        step_walls.append((step, time.perf_counter()))
        return real_run(self, batch, step)

    from tpu_pipelines_torch.orchestration import LocalDagRunner

    runs = []
    real_dag_run = LocalDagRunner.run

    def dag_run(self, *args, **kwargs):
        runs.append(real_dag_run(self, *args, **kwargs))
        return runs[-1]

    trial_walls = []
    real_trial = tuner_mod.run_trial

    def timed_trial(*args, **kwargs):
        t = time.perf_counter()
        try:
            return real_trial(*args, **kwargs)
        finally:
            trial_walls.append(time.perf_counter() - t)

    alerts = default_registry().counter(
        "watchdog_alerts_total", "Health watchdog alerts fired, by monitor "
        "and kind.", labels=("monitor", "kind"))
    stalls0 = alerts.labels("train_loop", "stall").get()
    zero_counters()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, env), \
            mock.patch.object(LocalDagRunner, "run", dag_run), \
            mock.patch.object(user, "train_loop", loop), \
            mock.patch.object(tuner_mod, "run_trial", timed_trial), \
            mock.patch.object(loop_module._TrainStep, "run", timed_run):
        code, out = cli(["run", "--pipeline-module", pipeline_path,
                         "--device", DEVICE])
    dag_s = time.perf_counter() - t0
    dag_launches = counters()
    if code != 0 or len(runs) != 1:
        raise AssertionError(f"tune_rewrite: run exited {code}: {out[-3000:]}")
    run = runs[0]
    states = {k: v.status for k, v in run.nodes.items()}
    if set(states.values()) != {"COMPLETE"} or len(states) != 10:
        raise AssertionError(f"tune_rewrite: nodes {states}")

    def uri(node, key):
        return run.outputs_of(node, key)[0].uri

    # The search: two rungs, the Trainer on the best rate.
    hp_uri = uri("Tuner", "best_hyperparameters")
    best = json.load(open(os.path.join(hp_uri, "best_hyperparameters.json")))
    trials = json.load(open(os.path.join(hp_uri, "trials.json")))
    with open(os.path.join(uri("Trainer", "model"), "model_spec.json")) as f:
        trainer_hp = json.load(f)["hyperparameters"]
    budgets = [t["train_steps"] for t in trials]
    deltas = [t["device_memory_delta_bytes"] for t in trials]
    trial_eps = [round(c[1].examples_per_sec, 2) for c in calls[:-1]]
    print(f"tune_rewrite DAG [{card}]: `python -m tpu_pipelines_torch run` "
          f"{dag_s:.1f} s, 10 nodes COMPLETE: " + ", ".join(
              f"{k} {v.wall_clock_s:.2f} s" for k, v in run.nodes.items()),
          flush=True)
    print(f"tune_rewrite Tuner [{card}]: successive halving over learning "
          f"rates {TUNE_LRS}: " + "; ".join(
              f"lr {t['hyperparameters']['learning_rate']:g} {t['train_steps']} "
              f"steps {t['objective']} {t['score']:.5f} memory delta "
              f"{t['device_memory_delta_bytes']} B" for t in trials)
          + f"; best {best['learning_rate']:g}; trial walls "
          f"{[round(w, 2) for w in trial_walls]} s (build, steps, eval, "
          f"checkpoint, export), examples/s over each trial's timed steps "
          f"{trial_eps}", flush=True)
    print(f"tune_rewrite Tuner node [{card}]: {run.nodes['Tuner'].wall_clock_s:.2f} s "
          f"for {len(trials)} in-process trials",
          flush=True)
    # Successive halving at eta 2: every rate at the first rung, the
    # better half at the second.
    if (budgets != [TUNE_RUNGS[0]] * len(TUNE_LRS)
            + [TUNE_RUNGS[1]] * (len(TUNE_LRS) // 2)
            or any(t["status"] != "ok" for t in trials)
            or trainer_hp["learning_rate"] != best["learning_rate"]):
        raise AssertionError(f"tune_rewrite: budgets {budgets}, best {best}, "
                             f"Trainer {trainer_hp}")
    if any(abs(d) > TUNE_MEM_MARGIN for d in deltas):
        raise AssertionError(f"tune_rewrite: an in-process trial kept device "
                             f"memory: deltas {deltas} (margin {TUNE_MEM_MARGIN})")

    # The Trainer: MFU from the loop, the counted FLOPs, the profile, the
    # TensorBoard scalars, goodput and the watchdog.
    config, result, shape = calls[-1]
    # One train_loop call per in-process trial, then the Trainer's.
    if (config.profile_dir != loop_options["profile_dir"]
            or len(calls) != len(trials) + 1):
        raise AssertionError(f"tune_rewrite: {len(calls)} train_loop calls")
    length = next(iter(BatchIterator(
        uri("Transform", "transformed_examples"), "train",
        InputConfig(batch_size=2, shuffle=False, num_epochs=1))))["input_ids"].shape[1]
    analytic = bert_flops(shape, hp["batch_size"], length)
    counted = result.cost_analysis_flops_per_step
    profiles = os.listdir(config.profile_dir)
    kernels = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
               "flash_bwd_dkv_mma_kernel")
    in_trace, n_kernels = profile_kernel_counts(
        os.path.join(config.profile_dir, profiles[0]), kernels)
    want_in_trace = (TUNE_PROFILE[1] - TUNE_PROFILE[0]) * DEFAULT_HPARAMS["n_layers"]
    walls = {s: t for s, t in step_walls}
    step_ms = {s: (walls[s + 1] - walls[s]) * 1e3 for s in walls if s + 1 in walls}
    profiled = [step_ms[s] for s in range(*TUNE_PROFILE)]
    plain = [ms for s, ms in step_ms.items()
             if s >= TUNE_PROFILE[1] + 1]
    scalars = read_event_scalars(config.tensorboard_dir)
    log_every = max(1, TUNE_STEPS // 10)
    stalls = alerts.labels("train_loop", "stall").get() - stalls0
    print(f"tune_rewrite Trainer [{card}]: lr {best['learning_rate']:g}, "
          f"{result.steps_completed} steps of {hp['batch_size']} x "
          f"{length} (windows of {result.window_steps}: profile_dir "
          f"forces 1), MFU from the loop {result.mfu} (counted "
          f"{counted:.6g} FLOP a step, analytic {analytic:.6g}, ratio "
          f"{counted / analytic:.4f}), {result.examples_per_sec_per_chip} "
          f"examples/s/chip", flush=True)
    print(f"tune_rewrite goodput [{card}]: {result.goodput} "
          f"({result.goodput_source}), badput {result.badput}, proxy "
          f"goodput_post_compile {result.goodput_post_compile}; stall alerts "
          f"{stalls} (timeout {TUNE_STALL_S:g} s)", flush=True)
    print(f"tune_rewrite profile [{card}]: {profiles} holds {n_kernels} "
          f"kernels, {in_trace} of the flash kernels (want {want_in_trace} "
          f"each); step wall profiled {[round(x, 3) for x in profiled]} ms "
          f"(the last one includes the profiler's stop and the trace's "
          f"export) against unprofiled median {np.median(plain):.3f} ms "
          f"(ratio of the first two {np.mean(profiled[:2]) / np.median(plain):.3f})",
          flush=True)
    print(f"tune_rewrite tensorboard: tags {sorted(scalars)}, loss at steps "
          f"{[s for s, _ in scalars.get('loss', [])]}", flush=True)
    if (result.mfu is None or result.cost_analysis_source != "counted"
            or abs(counted / analytic - 1) > TUNE_FLOP_TOL):
        raise AssertionError(f"tune_rewrite: MFU {result.mfu}, counted "
                             f"{counted} against analytic {analytic}")
    if len(profiles) != 1 or any(v != want_in_trace for v in in_trace.values()):
        raise AssertionError(f"tune_rewrite: profile {profiles}: {in_trace}")
    if [s for s, _ in scalars.get("loss", [])] != list(
            range(log_every, TUNE_STEPS + 1, log_every)) or "eval_loss" not in scalars:
        raise AssertionError(f"tune_rewrite: tensorboard scalars {scalars}")
    if (result.goodput_source != "goodput_tracker"
            or not 0 < result.goodput <= 1 or not result.badput
            or not set(result.badput) <= set(gp.BADPUT_KINDS)
            or not 0 < result.goodput_post_compile <= 1 or stalls):
        raise AssertionError(f"tune_rewrite: goodput {result}")

    # The Rewriter's report and the push.
    rewritten = uri("Rewriter", "model")
    report = json.load(open(os.path.join(rewritten, "rewrite_report.json")))
    variants = report["variants"]
    for name, info in variants.items():
        print(f"tune_rewrite Rewriter [{card}]: {name} latency "
              f"{info.get('latency_ms')} ms (32 rows, host fetch included), "
              f"resident {info['params_bytes']} B, accuracy delta "
              f"{info['quality_deltas']}, blessed {info['blessed']}", flush=True)
    print(f"tune_rewrite Rewriter: selected {report['selected_variant']}, "
          f"speedup against float32 {report['speedup_vs_float']}", flush=True)
    ratio = variants["aqt_int8"]["params_bytes"] / variants["float32"]["params_bytes"]
    if (sorted(variants) != ["aqt_int8", "bfloat16", "float32"]
            or any(info.get("latency_ms") is None for info in variants.values())
            or not variants["aqt_int8"]["blessed"] or ratio > INT8_BYTES_MAX):
        raise AssertionError(f"tune_rewrite: rewrite report {report}")
    versions = [d for d in os.listdir(push) if d.isdigit()]
    if len(versions) != 1:
        raise AssertionError(f"tune_rewrite: pushed {versions}")
    pushed = os.path.join(push, versions[0])
    with open(os.path.join(pushed, "model_spec.json")) as f:
        if json.load(f)["dtype"] != "aqt_int8":
            raise AssertionError("tune_rewrite: the push is not the int8 variant")

    # TunerIsolated's trial, run by the Tuner in a child process with the
    # device in its spec: the metrics of the in-process trial of its rate
    # and budget.
    with open(os.path.join(uri("TunerIsolated", "best_hyperparameters"),
                           "trials.json")) as f:
        child_trials = json.load(f)
    twin = [t for t in trials
            if t["hyperparameters"] == {"learning_rate": TUNE_LRS[0]}
            and t["train_steps"] == TUNE_RUNGS[0]]
    child = child_trials[0]
    child_launches = child.get("launches", {})
    in_process_s = trial_walls[trials.index(twin[0])] if twin else None
    print(f"tune_rewrite subprocess trial [{card}]: TunerIsolated "
          f"{run.nodes['TunerIsolated'].wall_clock_s:.2f} s for its one child "
          f"trial (process start included) against the in-process trial's "
          f"{in_process_s} s at {TUNE_RUNGS[0]} steps of lr {TUNE_LRS[0]:g}; "
          f"metrics {child.get('metrics')} vs "
          f"{twin[0]['metrics'] if twin else None}; child launches "
          f"{child_launches}", flush=True)
    if (len(child_trials) != 1 or len(twin) != 1 or child["status"] != "ok"
            or child["metrics"] != twin[0]["metrics"]
            or not child_launches.get("launches")):
        raise AssertionError(f"tune_rewrite: subprocess trial {child_trials}, "
                             f"in-process {twin}")

    # The pushed int8 payload served by a fleet: bucket graphs captured
    # before it serves, a 409 for an unblessed copy; the launches of the
    # served requests read before the checks' own computations (replay ==
    # eager, logits against float32).
    eval_rows = next(iter(BatchIterator(
        uri("Transform", "transformed_examples"), "eval",
        InputConfig(batch_size=TUNE_REQUESTS, shuffle=False, num_epochs=1))))
    transformed = {k: eval_rows[k] for k in ("input_ids", "attention_mask")}
    texts = [r[0] for r in review_rows(seed, TUNE_REQUESTS, part=7)]
    # The payload's graph reads every raw feature, the label included.
    requests = [{"instances": [{"text": t, "label": 0}]} for t in texts]
    server = ModelServer("bert", push, replicas=1, max_versions=2,
                         max_batch_size=8, device=DEVICE)
    fleet = server._fleet
    served = {}
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/bert"
        code0, first_reply = post_code(f"{url}:predict", requests[0])
        loaded = fleet.active_loaded()
        buckets = (fleet.last_warm or {}).get("buckets", [])
        int8_p50, counts, n = served_p50(f"{url}:predict", requests, fleet)
        served["aqt_int8"] = (counts, n)
        # An unblessed copy of the int8 payload: 409, version 1 serving on.
        bad = os.path.join(push, str(int(versions[0]) + 1))
        payload_copy(pushed, bad)
        spec_path = os.path.join(bad, "model_spec.json")
        spec = json.load(open(spec_path))
        spec["rewriter"] = {**spec.get("rewriter", {}), "blessed": False,
                            "reason": "a copy refused for the check"}
        os.unlink(spec_path)
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        zero_counters()
        batches0 = served_batches(fleet)
        refused = post_code(f"{url}:reload")
        code1, after_reply = post_code(f"{url}:predict", requests[0])
        served["aqt_int8 after the 409"] = (counters(),
                                            served_batches(fleet) - batches0)
        active = fleet.active_version

        raw = {"text": np.asarray(texts, dtype=object),
               "label": np.zeros(len(texts), np.int64)}

        def rows(b):
            return {k: v[:b] for k, v in raw.items()}

        unequal = [b for b in buckets if not np.array_equal(
            loaded.predict(rows(b)), eager(loaded, loaded.host_preprocess(rows(b))))]
        int8_resident = qz.params_nbytes(loaded.params)
        resident_int8 = sum(v.numel() for v in loaded.params.values()
                            if v.dtype == torch.int8)
        with torch.inference_mode():
            got = loaded.predict_transformed(transformed)
            control = loaded.predict_transformed(
                {**transformed,
                 "attention_mask": np.ones_like(transformed["attention_mask"])})
        dense = load_exported_model(variant_dirs(rewritten)["float32"],
                                    device=DEVICE)
        want = dense.predict_transformed(transformed)
        del dense
        scale = float(np.abs(want).max())
        gap = float(np.abs(got - want).max()) / scale
        control_gap = float(np.abs(control - want).max()) / scale
    finally:
        server.stop()
    print(f"tune_rewrite int8 fleet [{card}]: {len(buckets)} bucket graphs "
          f"{buckets} captured before the first reply; replay != eager at "
          f"{unequal}; p50 {int8_p50:.3f} ms over {TUNE_REQUESTS} requests; "
          f"resident {int8_resident} B ({resident_int8} int8 values); logits "
          f"vs float32 max gap {gap:.4e} of the largest (tolerance "
          f"{INT8_LOGIT_TOL:g}), mask-dropped control {control_gap:.4e}; "
          f"unblessed copy: {refused[0]} {str(refused[1])[:120]}; version "
          f"{active} still serving", flush=True)
    if code0 != 200 or not buckets or unequal:
        raise AssertionError(f"tune_rewrite: int8 fleet warm-up {code0}, "
                             f"buckets {buckets}, unequal {unequal}")
    if not gap <= INT8_LOGIT_TOL < control_gap:
        raise AssertionError(f"tune_rewrite: int8 logits gap {gap}, control "
                             f"{control_gap}")
    if (refused[0] != 409 or "NOT_BLESSED" not in str(refused[1])
            or code1 != 200 or after_reply != first_reply
            or active != versions[0]):
        raise AssertionError(f"tune_rewrite: unblessed copy {refused}, then "
                             f"{code1}, active {active}")

    # p50 of each variant behind a fleet of its own.
    p50 = {"aqt_int8": int8_p50}
    for name in ("bfloat16", "float32"):
        vbase = os.path.join(base, f"serve_{name}")
        payload_copy(variant_dirs(rewritten)[name], os.path.join(vbase, "1"))
        server = ModelServer("bert", vbase, replicas=1, max_versions=2,
                             max_batch_size=8, device=DEVICE)
        try:
            vurl = f"http://127.0.0.1:{server.start(port=0)}/v1/models/bert"
            p50[name], counts, n = served_p50(f"{vurl}:predict", requests,
                                              server._fleet)
            served[name] = (counts, n)
        finally:
            server.stop()
    print(f"tune_rewrite fleet p50 [{card}]: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in p50.items()) + " (one row a request, "
        "one after another, bucket graphs)", flush=True)
    print(f"tune_rewrite fleet launches [{card}]: " + "; ".join(
        f"{name} forward {counts['launches']} for {n} device batches"
        for name, (counts, n) in served.items()) + f" ({N_LAYERS} x batches "
        "expected, nothing else)", flush=True)
    for name, (counts, n) in served.items():
        check_served_launches(name, counts, n)
    # The DAG's (the in-process trials, the Trainer, the Evaluator, the
    # Rewriter), the child trial's and the fleets' served requests.
    total = {k: dag_launches[k] + child_launches.get(k, 0)
             + sum(counts[k] for counts, _ in served.values())
             for k in fa.COUNTERS}
    if total["decode_launches"] or not all(
            total[k] for k in ("launches", "dq_launches", "dkv_launches",
                               "dvec_launches")):
        raise AssertionError(f"tune_rewrite: launches {total}")
    print(f"tune_rewrite launches [{card}]: DAG {dag_launches}, child trial "
          f"{child_launches}, total {total}", flush=True)
    return by_record(total)


def build_kernels():
    """Build every CUDA source, one nvcc each, all started together."""
    seconds, errors = {}, {}

    def build(name):
        try:
            seconds[name] = _build.build(name)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors[name] = e

    threads = [threading.Thread(target=build, args=(name,))
               for name in ("flash_attention", "flash_attention_bwd",
                            "flash_decode")]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"kernel build failed: {errors}")
    print("build: " + ", ".join(f"{name}.cu in {sec:.1f} s" for name, sec in
                                seconds.items())
          + f" (0.0: already built); wall {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---- data-parallel training (A5)

# The dp_train phase.  (a) A world of one over NCCL in this process (a
# process group over a FileStore): BERT-base at full width, global batch
# DP_BATCH x SEQ_LEN, dropout 0 (so steps split into micro-batches and
# blocks compare with the single-device loop's), DP_STEPS steps in each
# mode of DP_RUNS from one capture.  (b) Two ranks on the one card over
# gloo, the backend the collectives' probe found carrying every collective
# on CUDA tensors (NCCL refuses two ranks on one device): each mode eagerly
# (gloo cannot be captured) at DP_TWO_LAYERS layers, dropout 0.1, and the
# elastic resume onto a world of one over NCCL, captured.  (c) Sync-BN:
# ResNet-50 at a world of one over NCCL, and BatchNorm buffers across (b)'s
# two ranks.
DP_BATCH = 64
DP_STEPS = 6
# (a)'s depth: BERT-base's width at 3 of its 12 layers (cut for the
# script's time limit: 6 in PR 20, 3 since PR 21).
DP_LAYERS = 3
DP_BLOCKS = 8
DP_LR = 2e-5
# (mode, grad_accum_steps); "" is the implicit mode (one all-reduce).
DP_RUNS = [("", 1), ("psum_bucketed", 1), ("psum_bucketed", 2),
           ("ordered", 2), ("fsdp", 1)]
DP_PROFILE = (4, 5)          # the profiled step of each (a) run
DP_TWO_LAYERS = 2
DP_TWO_STEPS = 4
DP_TWO_BACKEND = "gloo"
DP_VISION_BATCH = 64
DP_VISION_STEPS = 4
# Each step's loss in a mode against the single-device loop's on the same
# batches (relative): the implicit and psum modes at accumulation 1 run the
# same products; accumulation and ordered's blocks run them on 32 and 8
# rows instead of 64, so cuBLAS may pick other bf16 GEMMs whose sums round
# otherwise.
DP_LOSS_TOL = 1e-2
# Each mode's parameter changes over the run against the single-device
# loop's, as the relative L2 distance (param_change_gap).  On an H100:
# about 1e-9 at accumulation 1 (the same products), 4.1e-2 and 4.2e-2 for
# psum_bucketed and ordered at accumulation 2 (AdamW moves a parameter by
# about lr whatever its gradient, so bf16 noise on small gradients shows
# at full size).  A planted fault, psum_bucketed at accumulation 2 with
# every second micro-batch's gradient dropped (its loss kept), read 0.97
# and must land above the limit.
DP_CHANGE_TOL = 0.2
# fsdp against psum_bucketed at a world of one: the same values (the
# gathers and the reduce-scatter copy at W = 1), held as the relative L2
# distance of every parameter's change over the run.
DP_GRAD_TOL = 1e-6
DP_COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")


def dp_hparams(layers=None, dropout=0.0):
    hp = {**DEFAULT_HPARAMS, "attn_impl": "flash", "max_len": SEQ_LEN,
          "num_classes": 2, "dropout_rate": dropout}
    if layers is not None:
        hp["n_layers"] = layers
    return hp


def dp_config(mode, accum, steps, seed, hp, batch_size=DP_BATCH, **kw):
    """The loop's config of one data-parallel run.  fsdp gets a partition
    sharding every parameter on dim 0 over 'data', so a world of one
    gathers and reduce-scatters each (the default partition shards
    nothing on one rank)."""
    partition = None
    if mode == "fsdp":
        from tpu_pipelines_torch.parallel.partition import make_param_partition

        with torch.device("meta"):
            partition = make_param_partition(build_bert_model(hp),
                                             [(r".", ("data",))])
    return TrainLoopConfig(
        train_steps=steps, batch_size=batch_size, log_every=1, seed=seed,
        dp_collective=mode or None, collective_buckets=2,
        dp_grad_blocks=DP_BLOCKS, grad_accum_steps=accum,
        param_partition=partition, **kw)


@contextlib.contextmanager
def counted_collectives():
    """Count the collectives issued, and those issued inside a CUDA-graph
    capture, by name."""
    import torch.distributed as dist

    counts = {"issued": {}, "captured": {}}
    patches = []
    for name in DP_COLLECTIVES:
        real = getattr(dist, name)

        def wrapper(*args, _real=real, _name=name, **kwargs):
            counts["issued"][_name] = counts["issued"].get(_name, 0) + 1
            if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                counts["captured"][_name] = counts["captured"].get(_name, 0) + 1
            return _real(*args, **kwargs)

        patches.append(mock.patch.object(dist, name, wrapper))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield counts


def dp_run(hp, seed, batches, mode, accum, *, profile_dir="", ckpt="",
           checkpoint_every=0, loss_fn=bert_module.loss_fn,
           init=None, has_model_state=False, optimizer=None, window=1,
           train_steps=None):
    """train_loop over ``batches`` in ``mode`` (``train_steps``: the run's
    last step, default the batches'); returns (model, result, per-step
    losses, {captures, replays}, collectives counted)."""
    losses = []
    calls = {"captures": 0, "replays": 0}

    def counted(name, method):
        def wrapper(self, *args, **kwargs):
            calls[name] += 1
            return method(self, *args, **kwargs)
        return wrapper

    kw = {"window_steps": window, "anchor_every": 1}
    if profile_dir:
        kw.update(profile_dir=profile_dir, profile_from=DP_PROFILE[0],
                  profile_to=DP_PROFILE[1])
    graph = torch.cuda.CUDAGraph
    with mock.patch.object(graph, "replay", counted("replays", graph.replay)), \
            mock.patch.object(graph, "capture_begin",
                              counted("captures", graph.capture_begin)), \
            counted_collectives() as collectives:
        model, result = train_loop(
            loss_fn=loss_fn,
            init_params_fn=init or functools.partial(
                bert_module.init_params_fn, hyperparameters=hp),
            optimizer=optimizer or bert_module.adamw(DP_LR),
            train_iter=iter(batches),
            config=dp_config(mode, accum, train_steps or len(batches), seed,
                             hp, batch_size=len(next(iter(batches[0].values()))),
                             checkpoint_every=checkpoint_every, **kw),
            checkpoint_dir=ckpt, has_model_state=has_model_state,
            metrics_cb=lambda step, m: losses.append(m["loss"]),
            device=DEVICE,
        )
    return model, result, losses, calls, collectives


def dp_eager(hp, seed, batches, mode, accum, mesh, *, loss_fn=bert_module.loss_fn,
             init=None, has_model_state=False, optimizer=None):
    """The steps of ``dp_run`` written out eagerly: the loop's init, the
    mode's DataParallel step, ``_step_seed(seed, s)`` seeding its
    generators, each rank's rows copied to the device.  Returns (model,
    per-step losses)."""
    from tpu_pipelines_torch.trainer.data_parallel import DataParallel

    model = (init or functools.partial(bert_module.init_params_fn,
                                       hyperparameters=hp))(
        torch.Generator().manual_seed(seed), batches[0])
    model.to(DEVICE).train()
    config = dp_config(mode, accum, len(batches), seed, hp,
                       batch_size=len(next(iter(batches[0].values()))))
    dp = DataParallel.build(config, mesh, model, mode, has_model_state)
    opt = (optimizer or bert_module.adamw(DP_LR))(dp.parameters(model))
    dp.attach(model)
    generators = [torch.Generator(device=DEVICE)
                  for _ in range(dp.generator_count())]
    losses = []
    try:
        for s, batch in enumerate(batches):
            dp.seed_generators(generators, _step_seed(seed, s))
            local = {k: torch.as_tensor(v, device=DEVICE)
                     for k, v in dp.local_batch(batch).items()}
            loss, _ = dp.step(model, loss_fn, local, generators, opt, None)
            losses.append(float(loss))
    finally:
        dp.detach()
    dp.unshard(model)
    return model, losses


def trace_kernels(path):
    """(name, device µs) of every kernel and copy in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e.get("name", ""), float(e.get("dur", 0))) for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def collective_share(kernels):
    """The collectives' device time in a profiled trace (NCCL's kernels,
    and the copies: at a world of one NCCL reduces a collective to a copy
    or to nothing) over all device time; (share, nccl kernel names)."""
    total = sum(d for _, d in kernels) or 1.0
    nccl = [(n, d) for n, d in kernels if "nccl" in n.lower()]
    copies = [(n, d) for n, d in kernels
              if "memcpy" in n.lower() and "nccl" not in n.lower()]
    return (sum(d for _, d in nccl + copies) / total,
            sorted({n.split("(")[0] for n, _ in nccl}))


def dp_group(backend, world=1, rank=0):
    """A process group over a FileStore in a temporary directory (world
    of one: this process); returns the directory to clean up."""
    import datetime

    import torch.distributed as dist

    tmp = tempfile.TemporaryDirectory()
    store = dist.FileStore(os.path.join(tmp.name, "store"), world)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device(DEVICE, torch.cuda.current_device())
    dist.init_process_group(backend, store=store, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300), **kwargs)
    return tmp


def dropping_every_second_gradient():
    """bert_module.loss_fn with the gradient of every second call dropped
    and its loss kept: at accumulation 2 the eager first step and the
    capture call it for micro-batch 0, then 1, so micro-batch 1 of each
    step adds nothing to the update."""
    calls = [0]

    def loss_fn(model, batch, generator):
        loss, metrics = bert_module.loss_fn(model, batch, generator)
        calls[0] += 1
        if calls[0] % 2 == 0:
            loss = loss.detach() + 0.0 * loss
        return loss, metrics

    return loss_fn


def param_change_gap(a, b, init):
    """Relative L2 distance of two runs' parameter changes from ``init``."""
    num = den = 0.0
    for name, p in a.items():
        da = p.float() - init[name].float()
        db = b[name].float() - init[name].float()
        num += float((da - db).pow(2).sum())
        den += float(db.pow(2).sum())
    return (num / max(den, 1e-30)) ** 0.5


def dp_train_phase(seed, card):
    """ROADMAP A5 on the card: (a) every mode at a world of one over NCCL
    from one capture and (c) sync-BN, in a process of their own, so no
    process group, NCCL state or profiler session of theirs reaches the
    later phases; then (b) two ranks on the one card over gloo and the
    elastic resume onto a world of one.  Returns the four attention
    kernels' launches over (a)'s runs."""
    gc.collect()
    torch.cuda.empty_cache()
    one = dp_spawn(1, None, seed, [("one", "world_of_one", {"card": card})])[0]
    launches, failures = one["one"]
    failures = failures + dp_two_ranks_phase(seed, card)
    if failures:
        raise AssertionError("dp_train: " + "; ".join(failures))
    return launches


def dp_world_of_one(seed, card):
    """(a) and (c) in this process: the single-device loop, then a process
    group of one over NCCL and every mode of DP_RUNS, ordered's eager
    steps, fsdp against psum, and ResNet-50's sync-BN.  Returns (the
    attention kernels' launches over the modes' runs, failures)."""
    import torch.distributed as dist

    hp = dp_hparams(DP_LAYERS)
    batches = training_batches(seed, hp["vocab_size"], DP_STEPS, batch=DP_BATCH)
    layers = hp["n_layers"]

    # The single-device loop, before any process group exists.
    zero_counters()
    base_model, base_result, base_losses, base_calls, _ = dp_run(
        hp, seed, batches, None, 1)
    base_params = {n: p.detach().clone() for n, p in base_model.named_parameters()}
    del base_model
    init = {n: p.detach().to(DEVICE) for n, p in
            bert_module.init_params_fn(torch.Generator().manual_seed(seed),
                                       batches[0], hyperparameters=hp)
            .named_parameters()}
    failures = []
    if base_result.step_capture != "cuda_graph":
        failures.append(f"single-device loop {base_result.step_capture}")
    print(f"dp_train [{card}] (a) single-device loop: BERT-base at {layers} "
          f"layers, batch "
          f"{DP_BATCH} x {SEQ_LEN}, {DP_STEPS} steps: {base_calls}, "
          f"{base_result.anchored_examples_per_sec_per_chip} examples/s/chip",
          flush=True)
    launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "flash_bwd_dvec": 0}
    tmp = dp_group("nccl")
    try:
        print(f"dp_train [{card}] (a) world of one over {dist.get_backend()}, "
              f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
        runs = {}
        for mode, accum in DP_RUNS:
            key = f"{mode or 'implicit'}/accum{accum}"
            forwards = accum * (DP_BLOCKS if mode == "ordered" else 1)
            with tempfile.TemporaryDirectory() as prof:
                zero_counters()
                model, result, losses, calls, coll = dp_run(
                    hp, seed, batches, mode, accum, profile_dir=prof)
                got = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
                       "flash_bwd_dkv": fa.dkv_launches,
                       "flash_bwd_dvec": fa.dvec_launches}
                traces = [os.path.join(prof, f) for f in os.listdir(prof)]
                kernels = trace_kernels(traces[0])
            for name in launches:
                launches[name] += got[name]
            share, nccl_names = collective_share(kernels)
            gap = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
            want = layers * forwards * DP_STEPS
            runs[key] = {"params": {n: p.detach().clone()
                                    for n, p in model.named_parameters()},
                         "losses": losses}
            change = param_change_gap(runs[key]["params"], base_params, init)
            del model
            print(f"dp_train [{card}] (a) {key}: {calls}, {result.step_capture}, "
                  f"compiles after warm {result.compiles_after_warm}; collectives "
                  f"issued {coll['issued']}, inside the capture "
                  f"{coll['captured']}; launches {got} (want {want} each: "
                  f"{layers} layers x {forwards} forwards a step x {DP_STEPS} "
                  f"steps); {result.anchored_examples_per_sec_per_chip} "
                  f"examples/s/chip (single device "
                  f"{base_result.anchored_examples_per_sec_per_chip}); profiled "
                  f"replays: collective share {share:.4f}, NCCL kernels "
                  f"{nccl_names or 'none'} of {len(kernels)} device events; "
                  f"max rel loss gap to the single-device loop {gap:.3e}; "
                  f"parameter changes' relative L2 gap to it {change:.3e}",
                  flush=True)
            print(f"dp_train (a) {key} losses: "
                  + " ".join(f"{x:.6f}" for x in losses), flush=True)
            if calls != {"captures": 1, "replays": DP_STEPS - 1}:
                failures.append(f"{key}: {calls}")
            if result.step_capture != "cuda_graph" or result.dp_collective != mode:
                failures.append(f"{key}: {result.step_capture} {result.dp_collective}")
            if not coll["captured"]:
                failures.append(f"{key}: no collective inside the capture")
            if any(v != want for v in got.values()):
                failures.append(f"{key}: launches {got}, want {want}")
            if not np.isfinite(losses).all() or gap > DP_LOSS_TOL:
                failures.append(f"{key}: losses {losses}, gap {gap}")
            if change > DP_CHANGE_TOL:
                failures.append(f"{key}: parameter change gap {change}")

        # The planted fault: every second micro-batch's gradient dropped.
        model, _, losses, _, _ = dp_run(hp, seed, batches, "psum_bucketed", 2,
                                        loss_fn=dropping_every_second_gradient())
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
        change = param_change_gap({n: p.detach() for n, p in model.named_parameters()},
                                  base_params, init)
        del model
        print(f"dp_train (a) planted fault, psum_bucketed/accum2 with every "
              f"second micro-batch's gradient dropped: max rel loss gap "
              f"{gap:.3e} (tolerance {DP_LOSS_TOL:g}); parameter changes' "
              f"relative L2 gap {change:.3e} (tolerance {DP_CHANGE_TOL:g}, "
              f"must be missed)", flush=True)
        if change <= DP_CHANGE_TOL:
            failures.append(f"planted fault within DP_CHANGE_TOL: {change}")

        # ordered: replay == eager, bit for bit.
        model, eager_losses = dp_eager(hp, seed, batches, "ordered", 2,
                                       make_dp_mesh())
        graph = runs["ordered/accum2"]
        unequal = [n for n, p in model.named_parameters()
                   if not torch.equal(p.detach(), graph["params"][n])]
        print(f"dp_train (a) ordered replay vs eager: losses "
              f"{'equal' if eager_losses == graph['losses'] else 'DIFFER'} bit "
              f"for bit, {len(unequal)} parameters differ", flush=True)
        if eager_losses != graph["losses"] or unequal:
            failures.append(f"ordered replay != eager: {unequal[:4]}")
        gap = param_change_gap(runs["fsdp/accum1"]["params"],
                               runs["psum_bucketed/accum1"]["params"], init)
        print(f"dp_train (a) fsdp vs psum_bucketed: relative L2 gap of the "
              f"parameter changes {gap:.3e} (tolerance {DP_GRAD_TOL:g})", flush=True)
        if gap > DP_GRAD_TOL:
            failures.append(f"fsdp vs psum gap {gap}")
        del model, runs, init, base_params

        failures += dp_vision_phase(seed, card)
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    return launches, failures


def make_dp_mesh():
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    return make_mesh(device=DEVICE)


def dp_vision_phase(seed, card):
    """(c) ResNet-50 at a world of one over NCCL, psum_bucketed, grad
    accumulation 2, has_model_state: replay == eager bit for bit, running
    statistics included (cuDNN deterministic on both sides)."""
    hp = {**VISION_HP, "batch_size": DP_VISION_BATCH}
    rng = np.random.default_rng(seed + 41)
    size = hp["image_size"]
    batches = [{"image": rng.standard_normal((DP_VISION_BATCH, size, size, 3),
                                             np.float32),
                "label": rng.integers(0, hp["num_classes"],
                                      size=DP_VISION_BATCH).astype(np.int64)}
               for _ in range(DP_VISION_STEPS)]
    init = lambda generator, sample: vision_init(seed)
    opt = resnet_module.sgd(hp["learning_rate"], hp["momentum"])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    failures = []
    try:
        g_model, result, g_losses, calls, coll = dp_run(
            None, seed, batches, "psum_bucketed", 2, loss_fn=resnet_module.loss_fn,
            init=init, has_model_state=True, optimizer=opt)
        g_state = {k: v.clone() for k, v in g_model.state_dict().items()}
        del g_model
        e_model, e_losses = dp_eager(
            None, seed, batches, "psum_bucketed", 2, make_dp_mesh(),
            loss_fn=resnet_module.loss_fn, init=init, has_model_state=True,
            optimizer=opt)
        e_state = e_model.state_dict()
        unequal = [k for k, v in e_state.items() if not torch.equal(v, g_state[k])]
        first = vision_init(seed).state_dict()
        moved = sum(1 for k, v in g_state.items()
                    if "running" in k and not torch.equal(v.cpu(), first[k]))
        n_running = sum(1 for k in g_state if "running" in k)
        del e_model, e_state, g_state
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"dp_train [{card}] (c) ResNet-{hp['depth']} {size}x{size}, batch "
          f"{DP_VISION_BATCH}, psum_bucketed, grad_accum_steps 2, sync-BN: "
          f"{calls}, {result.step_capture}, collectives inside the capture "
          f"{coll['captured']}; replay vs eager: losses "
          f"{'equal' if g_losses == e_losses else 'DIFFER'}, {len(unequal)} state "
          f"tensors differ; {moved} of {n_running} running buffers moved",
          flush=True)
    if calls != {"captures": 1, "replays": DP_VISION_STEPS - 1}:
        failures.append(f"vision {calls}")
    if g_losses != e_losses or unequal or moved != n_running:
        failures.append(f"vision replay != eager: {unequal[:4]}, moved {moved}")
    return failures


def _dp_rank_worker(rank, world, backend, init_file, out_dir, seed, jobs):
    """One process of the dp_train phase on device 0: joins a ``backend``
    group of ``world`` (none for None) and runs ``jobs`` (``[(name, kind,
    kwargs)]``), saving what each gave to ``out_dir/<rank>.pt``."""
    import datetime
    import traceback

    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        if backend is not None:
            dist.init_process_group(
                backend, init_method=f"file://{init_file}", world_size=world,
                rank=rank, timeout=datetime.timedelta(seconds=300))
        for name, kind, kwargs in jobs:
            job = {"bert": _dp_bert_job, "bn": _dp_bn_job,
                   "world_of_one": dp_world_of_one, "sp": _sp_job,
                   "ep": _ep_job, "tp": _tp_job, "tp_run_fn": _tp_run_fn_job,
                   "pp": _pp_job, "t5_train": _t5_train_job,
                   "t5_decode": _t5_decode_job, "moe_tp": _moe_tp_job,
                   "spmd_node": _spmd_node_job}[kind]
            t0 = time.perf_counter()
            out[name] = job(seed, **kwargs)
            if isinstance(out[name], dict):
                out[name]["wall_s"] = time.perf_counter() - t0
    except BaseException:  # noqa: BLE001 (reported by the parent)
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _dp_bert_job(seed, *, mode, steps, first=0, ckpt="", checkpoint_every=0):
    """BERT-base at DP_TWO_LAYERS layers, dropout 0.1, over batches
    [first, steps) of the run's DP_TWO_STEPS."""
    hp = dp_hparams(DP_TWO_LAYERS, dropout=0.1)
    batches = training_batches(seed, hp["vocab_size"], DP_TWO_STEPS,
                               batch=DP_BATCH)[first:steps]
    model, result, losses, calls, coll = dp_run(
        hp, seed, batches, mode, 1, ckpt=ckpt, checkpoint_every=checkpoint_every,
        train_steps=steps)
    return {"params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "losses": losses, "calls": calls, "issued": coll["issued"],
            "captured": coll["captured"], "step_capture": result.step_capture,
            "dp_collective": result.dp_collective,
            "resumed_from_step": result.resumed_from_step,
            "replayed_steps": result.replayed_steps,
            "steps_completed": result.steps_completed}


def _dp_bn_job(seed):
    """ResNet-50's BatchNorm buffers after one psum_bucketed step of
    has_model_state training, and the mean of each rank's own statistics
    (a train-mode forward of its rows from the same initial buffers,
    gathered)."""
    import torch.distributed as dist

    from tpu_pipelines_torch.parallel.mesh import local_rows, make_mesh

    hp = {**VISION_HP, "batch_size": DP_VISION_BATCH}
    rng = np.random.default_rng(seed + 43)
    size = hp["image_size"]
    batch = {"image": rng.standard_normal((DP_VISION_BATCH, size, size, 3),
                                          np.float32),
             "label": rng.integers(0, hp["num_classes"],
                                   size=DP_VISION_BATCH).astype(np.int64)}
    model = vision_init(seed).to(DEVICE).train()
    rows = local_rows(batch, make_mesh(device=DEVICE))
    # The step's own forward (the loss_fn, gradients on) on this rank's
    # rows, from the same initial buffers: the statistics before the sync.
    resnet_module.loss_fn(model, {k: torch.as_tensor(v, device=DEVICE)
                                  for k, v in rows.items()}, None)
    own = [b.detach().clone() for b in bn_buffers(model)]
    gathered = [[torch.empty_like(b) for _ in range(dist.get_world_size())]
                for b in own]
    for b, out in zip(own, gathered):
        dist.all_gather(out, b)
    want = [(g[0] + g[1]) * 0.5 for g in gathered]
    trained, result, _, _, _ = dp_run(
        None, seed, [batch], "psum_bucketed", 1, loss_fn=resnet_module.loss_fn,
        init=lambda generator, sample: vision_init(seed), has_model_state=True,
        optimizer=resnet_module.sgd(hp["learning_rate"], hp["momentum"]))
    got = [b.detach() for b in bn_buffers(trained)]
    return {"buffers": [b.cpu() for b in got],
            "equal_to_mean": all(torch.equal(a, b) for a, b in zip(got, want)),
            "max_gap": max(float((a - b).abs().max()) for a, b in zip(got, want)),
            "moved": sum(not torch.equal(a, b) for a, b in zip(got, own)),
            "step_capture": result.step_capture}


def dp_spawn(world, backend, seed, jobs, timeout_s=600.0):
    """``jobs`` on ``world`` spawned processes of device 0 (ranks of a
    ``backend`` group, or no group for None); returns each one's results.
    They are joined within ``timeout_s`` and killed past it."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_dp_rank_worker, args=(
            r, world, backend, os.path.join(tmp, "init"), tmp, seed, jobs))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.1, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out = []
        for r in range(world):
            path = os.path.join(tmp, f"{r}.pt")
            if not os.path.exists(path):
                raise AssertionError(f"dp_train: rank {r} of {world} over "
                                     f"{backend} left no result")
            res = torch.load(path, weights_only=False)
            if "error" in res:
                raise AssertionError(f"dp_train: rank {r} of {world} over "
                                     f"{backend} failed:\n{res['error']}")
            out.append(res)
    return out


def dp_two_ranks_phase(seed, card):
    """(b) Two ranks on the one card over DP_TWO_BACKEND (NCCL refuses two
    ranks on one device; gloo carries every collective on CUDA tensors, by
    the probe), each mode eagerly, the ordered run held bit for bit
    against a world of one over NCCL, captured; the elastic resume onto
    that world; and BatchNorm's buffers synced across the two ranks.
    Returns the failures."""
    failures = []
    ckpt = tempfile.mkdtemp()
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    # Deterministic cuBLAS in every rank and in the world of one, so the
    # same GEMMs run wherever a block runs.
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        jobs = [("ordered", "bert", {"mode": "ordered", "steps": DP_TWO_STEPS}),
                ("elastic", "bert", {"mode": "ordered", "steps": 3, "ckpt": ckpt,
                                     "checkpoint_every": 2})]
        jobs += [(mode or "implicit", "bert", {"mode": mode, "steps": 2})
                 for mode in ("", "psum_bucketed", "fsdp")]
        jobs.append(("bn", "bn", {}))
        two = dp_spawn(2, DP_TWO_BACKEND, seed, jobs)
        # The kill: the step-3 save never became durable.
        os.unlink(os.path.join(ckpt, "ckpt_3.pt"))
        one = dp_spawn(1, "nccl", seed, [
            ("ordered", "bert", {"mode": "ordered", "steps": DP_TWO_STEPS}),
            ("resumed", "bert", {"mode": "ordered", "steps": DP_TWO_STEPS,
                                 "first": 2, "ckpt": ckpt,
                                 "checkpoint_every": 2})])[0]
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas

    def same(a, b):
        return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)

    for name in ("ordered", "elastic", "implicit", "psum_bucketed", "fsdp"):
        r0, r1 = two[0][name], two[1][name]
        print(f"dp_train [{card}] (b) two ranks on one card over "
              f"{DP_TWO_BACKEND}, {name}: {r0['step_capture']}; collectives "
              f"{r0['issued']}; ranks equal {same(r0['params'], r1['params'])}; "
              f"losses " + " ".join(f"{x:.6f}" for x in r0["losses"]), flush=True)
        if not same(r0["params"], r1["params"]) or r0["losses"] != r1["losses"]:
            failures.append(f"two ranks disagree in {name}")
        if r0["step_capture"] != f"eager: {DP_TWO_BACKEND} collectives cannot be captured":
            failures.append(f"{name}: {r0['step_capture']}")
        if not np.isfinite(r0["losses"]).all():
            failures.append(f"{name}: losses {r0['losses']}")
    print("dp_train (b) NCCL with two ranks on one device: not driven on one "
          "card (NCCL refuses a second rank on a device: 'invalid usage'); "
          "held by tier-1 over gloo", flush=True)
    print("dp_train (b) a captured step over two ranks: not driven on one "
          "card (gloo's collectives run on the host and cannot be captured); "
          "held by (a) at a world of one and by tier-1 over gloo", flush=True)
    w1, two_full = one["ordered"], two[0]["ordered"]
    equal = same(w1["params"], two_full["params"]) and w1["losses"] == two_full["losses"]
    print(f"dp_train (b) ordered, two ranks (eager, {DP_TWO_BACKEND}) vs a world "
          f"of one ({w1['step_capture']}, nccl), {DP_TWO_LAYERS} layers, G "
          f"{DP_BLOCKS}: {'equal' if equal else 'DIFFER'} bit for bit "
          f"(parameters and losses)", flush=True)
    if not equal or w1["step_capture"] != "cuda_graph":
        failures.append("two-rank ordered != world of one")
    resumed = one["resumed"]
    elastic_equal = same(resumed["params"], w1["params"])
    print(f"dp_train (b) elastic: two ranks ran 3 steps (durable checkpoint "
          f"at 2, the step-3 save lost), the survivor resumed at a world of "
          f"one over nccl ({resumed['step_capture']}) from step "
          f"{resumed['resumed_from_step']}, replayed {resumed['replayed_steps']} "
          f"step(s), finished at {resumed['steps_completed']}: "
          f"{'equal' if elastic_equal else 'DIFFERS'} bit for bit to the "
          f"uninterrupted world of one", flush=True)
    if (not elastic_equal or resumed["replayed_steps"] != 1
            or resumed["resumed_from_step"] != 2
            or resumed["steps_completed"] != DP_TWO_STEPS
            or resumed["step_capture"] != "cuda_graph"):
        failures.append(f"elastic resume: {resumed['replayed_steps']} replayed, "
                        f"equal {elastic_equal}")
    b0, b1 = two[0]["bn"], two[1]["bn"]
    bn_equal = all(torch.equal(a, b) for a, b in zip(b0["buffers"], b1["buffers"]))
    print(f"dp_train (b) sync-BN, ResNet-{VISION_HP['depth']}, one psum_bucketed "
          f"step of two ranks: buffers equal on both ranks {bn_equal}; equal to "
          f"the mean of each rank's own statistics: rank 0 "
          f"{b0['equal_to_mean']} (max gap {b0['max_gap']:.3e}), rank 1 "
          f"{b1['equal_to_mean']}; {b0['moved']} of {len(b0['buffers'])} buffers "
          f"moved", flush=True)
    if not (bn_equal and b0["equal_to_mean"] and b1["equal_to_mean"]
            and b0["moved"] == len(b0["buffers"])):
        failures.append("two-rank sync-BN")
    return failures


# ------------------------------------------ sequence and expert parallelism

MOE_EXPERTS = 8              # Switch-Base-8: experts on the odd layers
MOE_AUX_WEIGHT = 0.01        # the reference's loss: task + 0.01 x aux
# One full-width MoE block on the card (bf16, the trained layer-1 block on
# the input the training batch gives it) against the same block in f64 on
# the CPU, over the first MOE_CHECK_ROWS rows (routing groups are rows, so
# a row's output depends on its own tokens alone): the relative L2 error
# of the output.  bf16 rounds the tokens, the weights and the expert
# activations, about 2^-8 each; a token routed apart by a near-tie moves
# its own row only.  A control routing each token to its second-best
# expert must miss it.
MOE_BLOCK_TOL = 3e-2
MOE_CHECK_ROWS = 8
MOE_SERVE_REQUESTS = 32
LONG_SEQ = 2048              # bench.py's long-context leg
LONG_BATCH = 4
LONG_STEPS = 3
# The two-rank sequence, expert and MoE tensor-parallel runs' depth:
# BERT-base's width at 2 of its 12 layers (cut for the script's time
# limit: 6 in PR 20, 2 since PR 21).
SP_EP_LAYERS = 2
LONG_LR = 1e-2               # SGD: a parameter's change is its gradients'
EP_BATCH = 32
# Two ranks against one process, SGD over LONG_STEPS steps, dropout 0:
# the relative L2 distance of the parameter changes from the shared init,
# and each step's relative loss gap, on both ranks.  The sequence runs
# compute in f32 on both sides: in bf16 the two sides' GEMMs (a rank's
# 1024-token blocks against the whole 2048) round apart by 3.9e-2, above
# what dropping half the keys does at random init (attention near
# uniform), so no control could be told.  Measured on one H100 80GB HBM3
# (700 W) at --seed 0: ring 2.31e-5, Ulysses
# 2.24e-5, the control (rank 0 drops the block of its last ring hop)
# 2.17e-2, loss gaps 5.4e-7 and 8.3e-4; expert parallelism (bf16, one
# nonzero expert output a token in each sum) 2.4e-7, its control (rank 1's
# partial output left out of the combine) 0.365, loss gaps 0 and 6.8e-2.
# Each tolerance sits near the geometric mean of the sound gap and the
# control's.
SP_CHANGE_TOL = 1e-3
SP_LOSS_TOL = 1e-4
EP_CHANGE_TOL = 1e-4
EP_LOSS_TOL = 1e-4


def moe_hparams(length=SEQ_LEN, dropout=0.1, layers=N_LAYERS):
    return {**DEFAULT_HPARAMS, "attn_impl": "flash", "max_len": length,
            "num_classes": 2, "moe_experts": MOE_EXPERTS, "dropout_rate": dropout,
            "n_layers": layers}


def moe_loss_fn(model, batch, generator):
    """The reference's MoE objective (tests/test_moe.py): cross-entropy
    plus MOE_AUX_WEIGHT x the load-balancing loss of
    ``apply_with_moe_aux``; ``moe_aux`` reported."""
    features = {k: v for k, v in batch.items() if k != "label"}
    logits, aux = tfm.apply_with_moe_aux(model, features, generator=generator)
    loss = F.cross_entropy(logits.float(), batch["label"].long())
    return loss + MOE_AUX_WEIGHT * aux, {"moe_aux": aux}


def moe_run(hp, seed, batches, cost=False):
    """train_loop over ``batches`` with ``moe_loss_fn`` and the fused AdamW;
    returns (model, result, losses, moe_aux per step, {loss_fn calls,
    captures, replays}, the attention launches of its steps)."""
    losses, auxes = [], []
    calls = {"loss_fn": 0, "captures": 0, "replays": 0}

    def loss_fn(*args):
        calls["loss_fn"] += 1
        return moe_loss_fn(*args)

    def counted(name, method):
        def wrapper(self, *args, **kwargs):
            calls[name] += 1
            return method(self, *args, **kwargs)
        return wrapper

    def record(step, m):
        losses.append(m["loss"])
        auxes.append(m["moe_aux"])

    # The launches of the steps alone: read before the loop counts a step's
    # FLOPs (an eager forward and backward of its own).
    launches = {}
    loop_module = sys.modules[train_loop.__module__]
    real_count = loop_module.count_step_flops

    def counting(*args, **kwargs):
        launches.update(by_record(counters()))
        return real_count(*args, **kwargs)

    graph = torch.cuda.CUDAGraph
    with mock.patch.object(graph, "replay", counted("replays", graph.replay)), \
            mock.patch.object(graph, "capture_begin",
                              counted("captures", graph.capture_begin)), \
            mock.patch.object(loop_module, "count_step_flops", counting):
        model, result = train_loop(
            loss_fn=loss_fn,
            init_params_fn=functools.partial(bert_module.init_params_fn,
                                             hyperparameters=hp),
            optimizer=bert_module.adamw(TRAIN_LR), train_iter=iter(batches),
            config=TrainLoopConfig(
                train_steps=len(batches), batch_size=len(batches[0]["label"]),
                log_every=1, window_steps=TRAIN_WINDOW, anchor_every=TRAIN_WINDOW,
                seed=seed, collect_cost_analysis=cost),
            metrics_cb=record, device=DEVICE)
    if not cost:
        launches.update(by_record(counters()))
    return model, result, losses, auxes, calls, launches


def moe_eager(hp, seed, batches):
    """The steps of ``moe_run`` written out eagerly; (losses, model)."""
    model = bert_module.init_params_fn(
        torch.Generator().manual_seed(seed), batches[0], hyperparameters=hp)
    model.to(DEVICE).train()
    opt = bert_module.adamw(TRAIN_LR)(model.parameters())
    losses = []
    for s, batch in enumerate(batches):
        dev_batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
        loss, _ = moe_loss_fn(model, dev_batch, step_generator(seed, s, DEVICE))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return [x.item() for x in losses], model


@contextlib.contextmanager
def dense_in_place_of_flash():
    """The port's attention layers run dense attention where they would
    launch the flash kernel: the same weights, the reference's math."""
    def dense(q, k, v, *, causal=False, kv_mask=None):
        return dense_attention(q, k, v, causal=causal, kv_mask=kv_mask)

    with mock.patch.object(tfm, "flash_attention", dense):
        yield


@contextlib.contextmanager
def routing_recorded():
    """Record every MoE layer's top-1 one-hot, in call order, into the
    list this yields."""
    chosen = []
    real = tfm.MoEMlpBlock._route

    def route(self, t):
        out = real(self, t)
        chosen.append(out[1])
        return out

    with mock.patch.object(tfm.MoEMlpBlock, "_route", route):
        yield chosen


@contextlib.contextmanager
def routing_imposed(chosen):
    """Every MoE layer routes as ``chosen`` (``routing_recorded``'s list,
    in the same call order) says, with its own router probabilities for
    the gates."""
    real = tfm.MoEMlpBlock._route
    queue = list(chosen)

    def route(self, t):
        probs, _, _, capacity = real(self, t)
        sel = queue.pop(0)
        place = (torch.cumsum(sel, dim=1) * sel).sum(dim=-1) - 1
        return probs, sel, place, capacity

    with mock.patch.object(tfm.MoEMlpBlock, "_route", route):
        yield
    if queue:
        raise AssertionError(f"routing_imposed: {len(queue)} routings unused")


def moe_block_f64(block, x, second_best=False):
    """``block`` (an MoEMlpBlock) on ``x`` [b, l, d] in f64 on the CPU,
    written out token by token: f32-free routing (the top expert, or the
    second with ``second_best``), the capacity by queue position, the
    gate-weighted tanh-gelu expert MLP."""
    wr = block.router.weight.detach().double().cpu()
    br = block.router.bias.detach().double().cpu()
    wi = block.wi.detach().double().cpu()
    wo = block.wo.detach().double().cpu()
    t = x.detach().double().cpu()                       # one group a row
    probs = torch.softmax(t @ wr.T + br, dim=-1)
    expert = probs.argsort(dim=-1, descending=True)[..., 1 if second_best else 0]
    gate = probs.gather(-1, expert[..., None])[..., 0]
    e, l = probs.shape[-1], t.shape[1]
    capacity = max(1, int(np.ceil(block.capacity_factor * l / e)))
    sel = F.one_hot(expert, e)
    place = (torch.cumsum(sel, dim=1) * sel).sum(-1) - 1
    out = torch.zeros_like(t)
    for j in range(e):
        rows = (expert == j) & (place < capacity)
        h = F.gelu(t[rows] @ wi[j], approximate="tanh")
        out[rows] = gate[rows][:, None] * (h @ wo[j])
    return out


def moe_block_check(model, batch, card):
    """The trained layer-1 MoE block on the card against ``moe_block_f64``
    on the input the batch gives it (see MOE_BLOCK_TOL); its timing at the
    main path's shape; the dispatch's kept share and tokens per expert."""
    block = model.encoder.layers[1].moe
    seen = {}
    hook = block.register_forward_pre_hook(
        lambda mod, args: seen.setdefault("x", args[0].detach().clone()))
    model.eval()
    with torch.no_grad():
        bert_module.loss_fn(model, {k: torch.as_tensor(v, device=DEVICE)
                                    for k, v in batch.items()}, None)
    hook.remove()
    x = seen["x"]
    with torch.no_grad():
        got = block(x).float().cpu()[:MOE_CHECK_ROWS]
        ms = time_ms(lambda: block(x), iters=20, warmup=3)
        routing = block.routing(x)
    rows = x[:MOE_CHECK_ROWS]
    want = moe_block_f64(block, rows)
    err = float((got.double() - want).norm() / want.norm())
    control = float((got.double() - moe_block_f64(block, rows, second_best=True)).norm()
                    / want.norm())
    per_expert = routing["tokens_per_expert"].cpu().tolist()
    kept = float(routing["kept_share"])
    print(f"moe_train block [{card}]: layer 1's MoE block ({MOE_EXPERTS} experts, "
          f"capacity factor {block.capacity_factor}, bf16) on {tuple(x.shape)}: "
          f"{ms:.3f} ms; rel L2 |card - f64 CPU| over {MOE_CHECK_ROWS} rows "
          f"{err:.3e} (tol {MOE_BLOCK_TOL:g}); control, second-best expert: "
          f"{control:.3e} (must exceed it); dispatch kept {kept:.4f}, dropped "
          f"{1 - kept:.4f}; tokens per expert {per_expert}", flush=True)
    if err > MOE_BLOCK_TOL:
        raise AssertionError(f"moe_train: the MoE block on the card is {err:.3e} "
                             "from its f64 version")
    if control <= MOE_BLOCK_TOL:
        raise AssertionError("moe_train: second-best routing stays within "
                             "MOE_BLOCK_TOL: the block check cannot tell routing")


def moe_replay_by_kind(model, seed, batch, iters=2):
    """Device ms per replayed MoE step of ``model`` (a fresh AdamW) by kind
    (GEMM, the attention kernels, routing and other elementwise work), from
    torch.profiler over windows of TRAIN_WINDOW replays."""
    model.train()
    state = TrainState(step=0, model=model, seed=seed,
                       optimizer=bert_module.adamw(TRAIN_LR)(model.parameters()))
    runner = _TrainStep(state, moe_loss_fn, torch.device(DEVICE),
                        torch.cuda.Stream(DEVICE))
    dev_batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    runner.run(dev_batch, 0)

    def window(i):
        for j in range(TRAIN_WINDOW):
            runner.run(dev_batch, 1 + i * TRAIN_WINDOW + j)
        torch.cuda.synchronize()

    wall_ms, profiled_ms, busy_ms, by_name, _ = profiled(window, iters)
    kinds = {"gemm": 0.0, "attention": 0.0, "routing and other": 0.0}
    for name, us in by_name.items():
        kind = ("attention" if re.search(r"flash_", name) else
                "gemm" if re.search(r"gemm|nvjet|cutlass|xmma|cublas", name, re.I)
                else "routing and other")
        kinds[kind] += us / iters / TRAIN_WINDOW / 1e3
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"moe_train replay top kernel: "
              f"{us / iters / TRAIN_WINDOW / 1e3:.3f} ms/step {name[:110]}",
              flush=True)
    return wall_ms / TRAIN_WINDOW, busy_ms / TRAIN_WINDOW, kinds


def moe_train_phase(seed, n_steps, card):
    """BERT-base-MoE (Switch-Base-8 layout) fine-tunes through train_loop,
    one capture and replays.  Returns (the attention kernels' launches,
    the trained state on the host)."""
    hp = moe_hparams()
    batches = training_batches(seed + 5, hp["vocab_size"], n_steps)
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    model, result, losses, auxes, calls, launches = moe_run(hp, seed, batches,
                                                            cost=True)
    peak_bytes = torch.cuda.max_memory_allocated()
    experts = {n: p.detach().clone() for n, p in model.named_parameters()
               if ".moe." in n}
    eager_losses, eager_model = moe_eager(hp, seed, batches)
    experts_equal = all(torch.equal(p, experts[n])
                        for n, p in eager_model.named_parameters() if n in experts)
    del eager_model
    moe_block_check(model, batches[0], card)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    wall_ms, busy_ms, kinds = moe_replay_by_kind(model, seed, batches[0])
    del model
    eps = result.anchored_examples_per_sec_per_chip
    print(f"moe_train [{card}]: BERT-base-MoE ({MOE_EXPERTS} experts on the odd "
          f"layers, capacity 1.25, d_model {hp['d_model']}, {hp['n_layers']} "
          f"layers) bf16, dropout {hp['dropout_rate']}, flash attention, batch "
          f"{TRAIN_BATCH} x {SEQ_LEN} ragged, fused AdamW {TRAIN_LR:g}, loss "
          f"task + {MOE_AUX_WEIGHT:g} x aux, {result.steps_completed} steps in "
          f"windows of {result.window_steps}", flush=True)
    print("moe_train losses: " + " ".join(f"{x:.5f}" for x in losses), flush=True)
    print("moe_train moe_aux: " + " ".join(f"{x:.4f}" for x in auxes), flush=True)
    print(f"moe_train: {eps} examples/s/chip anchored over {result.anchor_windows} "
          f"windows ({result.examples_per_sec_per_chip} whole-run); MFU "
          f"{result.mfu} from counted FLOPs ({result.cost_analysis_flops_per_step} "
          f"a step, {result.cost_analysis_source}); peak device memory "
          f"{peak_bytes} bytes", flush=True)
    print(f"moe_train: launches {launches} = {N_LAYERS} x {n_steps} steps "
          f"expected for each, counted at replay; graph: {calls}, compiles "
          f"after warm {result.compiles_after_warm}; against the same steps run "
          f"eagerly: losses {'equal' if losses == eager_losses else 'DIFFER'} "
          f"bit for bit, final expert weights "
          f"{'equal' if experts_equal else 'DIFFER'} bit for bit", flush=True)
    print(f"moe_train step [{card}] graph replay: host wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms; device ms by kind: "
          + ", ".join(f"{k} {v:.3f}" for k, v in kinds.items()), flush=True)
    if len(losses) != n_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"moe_train: losses {losses}")
    if min(auxes) < 1.0:
        raise AssertionError(f"moe_train: moe_aux below 1: {auxes}")
    want = {"flash_fwd": N_LAYERS * n_steps, "flash_bwd_dvec": N_LAYERS * n_steps,
            "flash_bwd_dq": N_LAYERS * n_steps, "flash_bwd_dkv": N_LAYERS * n_steps,
            "flash_decode": 0}
    if launches != want:
        raise AssertionError(f"moe_train: launches {launches}, want {want}")
    if (calls != {"loss_fn": 3, "captures": 1, "replays": n_steps - 1}
            or result.compiles_after_warm != 0):
        raise AssertionError(f"moe_train: every step after the first must be a "
                             f"replay of one capture: {calls}")
    if losses != eager_losses or not experts_equal:
        raise AssertionError("moe_train: the graph run differs from the same "
                             "steps run eagerly")
    return launches, state


def moe_serving_phase(seed, card, workdir, state):
    """The trained MoE payload exported through the BERT module and served
    from the boot version's bucket graphs.  Returns the forward's
    launches."""
    hp = moe_hparams()
    base = os.path.join(workdir, "bert_moe")
    export_model(serving_model_dir=os.path.join(base, "1"), params=state,
                 module_file=BERT_MODULE, hyperparameters=hp)
    requests = make_requests(np.random.default_rng(seed + 23), MOE_SERVE_REQUESTS,
                             hp["vocab_size"])
    rows = [r for p in requests for r in p["instances"]]
    ids = np.asarray([r["input_ids"] for r in rows])
    mask = np.asarray([r["attention_mask"] for r in rows])
    server = ModelServer("bert_moe", base, replicas=1, max_versions=2,
                         max_batch_size=FLEET_BATCH, device="cuda")
    fleet = server._fleet
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/bert_moe:predict"
        warm, _ = run_clients(url, requests[:1], n_procs=1, threads=1)
        if warm[0][0] != 200:
            raise AssertionError(f"moe_serving: warm-up answered {warm[0][0]}")
        warm1 = dict(fleet.last_warm or {})
        loaded = fleet.active_loaded()
        buckets = warm1.get("buckets", [])
        unequal = [b for b in buckets if not np.array_equal(
            loaded.predict({"input_ids": ids[:b], "attention_mask": mask[:b]}),
            eager(loaded, {"input_ids": ids[:b], "attention_mask": mask[:b]}))]
        zero_counters()
        batches0 = served_batches(fleet)
        results, wall_s = run_clients(url, requests)
        launches = counters()
        n_batches = served_batches(fleet) - batches0
        after_warm = loaded.aot.compiles_after_warm
    finally:
        server.stop()
    if any(c != 200 for c, _, _ in results):
        raise AssertionError("moe_serving: non-200 replies "
                             f"{sorted({c for c, _, _ in results})}")
    served = np.concatenate([np.asarray(reply["predictions"], np.float32)
                             for _, reply, _ in results])

    def predict(model, mask_rows):
        return np.concatenate([
            eager(model, {"input_ids": ids[i:i + 32],
                          "attention_mask": mask_rows[i:i + 32]})
            for i in range(0, len(rows), 32)])

    # Dense attention under the flash step's routing: each MoE layer's
    # top-1 choice recorded from the flash step and imposed on the dense
    # one, so the comparison holds the attention kernel (a near-tie the
    # two attentions round apart would send a token to another expert and
    # move its row by far more than bf16 does).
    with routing_recorded() as chosen:
        flash_eager = predict(loaded, mask)
    with routing_imposed(chosen), dense_in_place_of_flash():
        want = predict(loaded, mask)
    max_err = float(np.abs(flash_eager - want).max())
    if served.shape != flash_eager.shape:
        raise AssertionError(f"moe_serving: served {served.shape}, want "
                             f"{flash_eager.shape}")
    served_gap = np.abs(served - flash_eager).max(axis=-1)
    shifted_gap = float(np.abs(served - np.roll(flash_eager, 1, axis=0)).max())
    control_err = {
        name: float(np.abs(predict(loaded, m) - want).max())
        for name, m in (("mask dropped", np.ones_like(mask)),
                        ("mask of the next row", np.roll(mask, 1, axis=0)))}
    with dense_in_place_of_flash():
        free = predict(loaded, mask)
    free_err = float(np.abs(flash_eager - free).max())
    del loaded
    lat_ms = np.array([t for _, _, t in results]) * 1e3
    print(f"moe_serving [{card}]: BERT-base-MoE payload through the BERT module, "
          f"buckets {buckets} captured in {warm1.get('seconds', 0.0):.3f} s "
          f"(fallback_warm {warm1.get('fallback_warm')}); each bucket's replay "
          f"== eager bit for bit: {'yes' if not unequal else unequal}; "
          f"{len(requests)} requests ({len(rows)} rows) in {n_batches} device "
          f"batches, p50 {np.percentile(lat_ms, 50):.2f} ms, p99 "
          f"{np.percentile(lat_ms, 99):.2f} ms, {len(rows) / wall_s:.1f} "
          f"examples/s; launches {launches} ({N_LAYERS} x batches expected, "
          f"credited per replay); compiles after warm {after_warm}", flush=True)
    print(f"moe_serving: max |flash - dense| logit under the flash step's "
          f"routing = {max_err:.3e} (tol {LOGIT_TOL:g}); controls: " + ", ".join(
              f"{k} {v:.3e}" for k, v in control_err.items())
          + f" (each must exceed the tol); dense routing its own way: "
          f"{free_err:.3e}; served replies against the eager flash step on "
          f"32-row chunks: max {served_gap.max():.3e}, rows within "
          f"{LOGIT_TOL:g}: {(served_gap <= LOGIT_TOL).mean():.4f} (every row "
          f"must be); control, the replies shifted by one row: "
          f"{shifted_gap:.3e} (must exceed the tol)", flush=True)
    check_served_launches("moe_serving", launches, n_batches)
    if unequal or after_warm != 0 or not buckets:
        raise AssertionError(f"moe_serving: buckets {buckets}, unequal {unequal}, "
                             f"compiles after warm {after_warm}")
    if max_err > LOGIT_TOL or min(control_err.values()) <= LOGIT_TOL:
        raise AssertionError("moe_serving: the served logits against dense "
                             "attention (or a control) are off")
    if served_gap.max() > LOGIT_TOL or shifted_gap <= LOGIT_TOL:
        raise AssertionError(
            f"moe_serving: served replies {served_gap.max():.3e} from the eager "
            f"flash step (shifted control {shifted_gap:.3e}), tol {LOGIT_TOL:g}")
    return launches["launches"]


def long_hparams(impl):
    return {**DEFAULT_HPARAMS, "attn_impl": impl, "max_len": LONG_SEQ,
            "num_classes": 2, "dropout_rate": 0.0, "n_layers": SP_EP_LAYERS}


def f32_compute(model, dtype=torch.float32):
    """``model`` with every module's compute dtype ``dtype`` (f32: its
    parameters are f32 already; f64: they are cast)."""
    for module in model.modules():
        if isinstance(getattr(module, "dtype", None), torch.dtype):
            module.dtype = dtype
    return model if dtype == torch.float32 else model.to(dtype)


def parallel_run(hp, seed, batches, mesh=None, batch_partition=None,
                 loss_fn=bert_module.loss_fn, f32=False, param_partition=None,
                 build=None, hook=None, step_times=None, f64=False):
    """train_loop with SGD (LONG_LR) over ``batches`` on ``mesh`` (in f32
    compute with ``f32``, f64 with ``f64``; ``build(generator, batch)`` makes the model, by
    default the BERT module's, and ``hook(model)`` sees it first); returns
    (the final whole model, per-step losses, result, the initial
    parameters on the device: whole, the slices a module holds over
    ``model`` or ``pipe`` gathered; under expert parallelism the rank's
    slice of the experts).  ``step_times`` collects each step's end on the
    host clock."""
    from tpu_pipelines_torch.parallel.partition import gather_whole, held_slices

    losses, start = [], {}
    build = build or functools.partial(bert_module.init_params_fn,
                                       hyperparameters=hp, mesh=mesh)

    def init(generator, batch):
        model = build(generator, batch)
        if hook is not None:
            hook(model)
        for n, p in model.named_parameters():
            start[n] = gather_whole(p.detach(), held_slices(model, n)).to(
                DEVICE, copy=True)
        if f64:
            return f32_compute(model, torch.float64)
        return f32_compute(model) if f32 else model

    def record(step, metrics):
        losses.append(metrics["loss"])
        if step_times is not None:
            step_times.append(time.perf_counter())

    model, result = train_loop(
        loss_fn=loss_fn,
        init_params_fn=init,
        optimizer=lambda p: torch.optim.SGD(p, lr=LONG_LR),
        train_iter=iter(batches),
        config=TrainLoopConfig(train_steps=len(batches),
                               batch_size=len(next(iter(batches[0].values()))),
                               log_every=1, window_steps=1, seed=seed,
                               batch_partition=batch_partition,
                               param_partition=param_partition),
        mesh=mesh, metrics_cb=record, device=DEVICE)
    return model, losses, result, start


def change_gap(model, start, want_path):
    """Relative L2 distance of ``model``'s parameter change from ``start``
    to that of the state saved at ``want_path`` (the one-process run from
    the same init), over every parameter, on the device.  An expert
    parameter's start is the rank's slice: its whole init is the saved
    run's own, gathered from its own rank's slices as the model is."""
    want = torch.load(want_path, map_location=DEVICE, weights_only=True)
    num = den = 0.0
    for name, p in model.named_parameters():
        base = start[name]
        if base.shape != p.shape:   # an expert slice: gather the ranks' starts
            from tpu_pipelines_torch.parallel.partition import all_gather_dim

            base = all_gather_dim(base, 0, torch.distributed.group.WORLD)
        d_got = (p.detach() - base).double()
        d_want = (want[name] - base).double()
        num += float((d_got - d_want).square().sum())
        den += float(d_want.square().sum())
    return (num / den) ** 0.5


def _sums(model):
    """Each parameter's f64 sum: two ranks holding the same model agree on
    every one."""
    return {n: float(p.detach().double().sum()) for n, p in model.named_parameters()}


def long_batches(seed, n=LONG_STEPS):
    return training_batches(seed + 29, DEFAULT_HPARAMS["vocab_size"], n,
                            batch=LONG_BATCH, length=LONG_SEQ)


def ep_batches(seed, n=LONG_STEPS):
    return training_batches(seed + 31, DEFAULT_HPARAMS["vocab_size"], n,
                            batch=EP_BATCH)


def _sp_job(seed, *, impl, want_path, control=False):
    """One rank of BERT-base at L = LONG_SEQ split over seq = 2
    (``long_context_batch_partition``) with ``impl`` attention.  The
    control: rank 0 drops the block of its last ring hop."""
    import torch.distributed as dist

    from tpu_pipelines_torch.parallel import ring_attention as ra
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    zero_counters()
    mesh = make_mesh({"data": 1, "seq": 2}, device=DEVICE)
    hp = long_hparams(impl)
    batches = long_batches(seed)
    bp = ra.long_context_batch_partition(batches[0], mesh)
    real = ra._scores

    def dropping_last_hop(q, k, *, kv_offset, **kw):
        s = real(q, k, kv_offset=kv_offset, **kw)
        if dist.get_rank() == 0 and kv_offset == q.shape[1]:
            # Still in the graph: every rank's received K/V block must take
            # a gradient, or the ring's backward exchanges would part.
            s = s.masked_fill(torch.ones_like(s, dtype=torch.bool), ra.NEG_INF)
        return s

    t0 = time.perf_counter()
    with (mock.patch.object(ra, "_scores", dropping_last_hop) if control
          else contextlib.nullcontext()):
        model, losses, result, start = parallel_run(hp, seed, batches, mesh, bp,
                                                    f32=True)
    seconds = time.perf_counter() - t0
    return {"losses": losses, "sums": _sums(model), "seconds": seconds,
            "gap": change_gap(model, start, want_path),
            "step_capture": result.step_capture, "batch_partition": bp,
            "launches": by_record(counters())}


def _ep_job(seed, *, want_path, control=False):
    """One rank of BERT-base-MoE at L = SEQ_LEN over expert = 2 (4 of the
    8 experts a rank).  The control: rank 1's partial output is left out
    of the combine."""
    import torch.distributed as dist

    from tpu_pipelines_torch.parallel import collectives
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    zero_counters()
    mesh = make_mesh({"data": 1, "expert": 2}, device=DEVICE)
    hp = moe_hparams(dropout=0.0, layers=SP_EP_LAYERS)
    batches = ep_batches(seed)
    real = collectives.leave_partial

    def leaving_rank_1_out(x, group):
        return real(x * 0 if dist.get_rank() == 1 else x, group)

    t0 = time.perf_counter()
    with (mock.patch.object(collectives, "leave_partial", leaving_rank_1_out)
          if control else contextlib.nullcontext()):
        model, losses, result, start = parallel_run(hp, seed, batches, mesh,
                                                    loss_fn=moe_loss_fn)
    seconds = time.perf_counter() - t0
    return {"losses": losses, "sums": _sums(model), "seconds": seconds,
            "gap": change_gap(model, start, want_path),
            "step_capture": result.step_capture, "launches": by_record(counters())}


def seq_expert_setup(seed, card, tmp):
    """(c) seq_expert_two_ranks: two ranks on the one card over gloo (the
    probe's exchanges: all_to_all_single with uneven splits; NCCL refuses
    two ranks on one device), each held against one process running the
    same steps: BERT-base at L = LONG_SEQ over seq = 2 with ring and with
    Ulysses (against flash in one process), and BERT-base-MoE over expert
    = 2 (against all 8 experts in one process).  Each rank's job counts
    its own launches from zero: none for ring and Ulysses (their blocks
    are plain torch), SP_EP_LAYERS x LONG_STEPS of each training kernel
    for EP.  Returns the one-process runs' rank jobs and ``finish(two,
    seconds)`` -> (the two ranks' launches summed over the ring, Ulysses
    and EP jobs, the failures); ``two_rank_jobs`` runs them."""
    zero_counters()
    t0 = time.perf_counter()
    one_long, long_losses, long_result, _ = parallel_run(
        long_hparams("flash"), seed, long_batches(seed), f32=True)
    long_path = os.path.join(tmp, "long.pt")
    torch.save({n: p.detach().cpu() for n, p in one_long.named_parameters()},
               long_path)
    del one_long
    one_ep, ep_losses, ep_result, _ = parallel_run(
        moe_hparams(dropout=0.0, layers=SP_EP_LAYERS), seed, ep_batches(seed),
        loss_fn=moe_loss_fn)
    ep_path = os.path.join(tmp, "ep.pt")
    torch.save({n: p.detach().cpu() for n, p in one_ep.named_parameters()},
               ep_path)
    del one_ep
    one_launches = by_record(counters())
    one_s = time.perf_counter() - t0
    jobs = [("ring", "sp", {"impl": "ring", "want_path": long_path}),
            ("ulysses", "sp", {"impl": "ulysses", "want_path": long_path}),
            ("ring_control", "sp", {"impl": "ring", "want_path": long_path,
                                    "control": True}),
            ("ep", "ep", {"want_path": ep_path}),
            ("ep_control", "ep", {"want_path": ep_path, "control": True})]
    return jobs, functools.partial(
        _seq_expert_finish, card, long_losses, long_result, ep_losses,
        one_launches, one_s)


def _seq_expert_finish(card, long_losses, long_result, ep_losses, one_launches,
                       one_s, two, two_s):
    failures = []
    print(f"seq_expert_two_ranks [{card}]: one process (captured, "
          f"{long_result.step_capture}): BERT-base at {SP_EP_LAYERS} layers, "
          f"flash (f32) at {LONG_BATCH} x {LONG_SEQ}, losses "
          + " ".join(f"{x:.6f}" for x in long_losses)
          + f"; BERT-base-MoE at {SP_EP_LAYERS} layers, {EP_BATCH} x {SEQ_LEN}, "
          "losses " + " ".join(f"{x:.6f}" for x in ep_losses)
          + f"; {one_s:.1f} s; launches {one_launches} (the one-process "
          "runs', not the ranks')", flush=True)
    print(f"seq_expert_two_ranks: two ranks over {DP_TWO_BACKEND} "
          f"({two[0]['ring']['step_capture']}), {two_s:.1f} s", flush=True)
    for name, want, change_tol, loss_tol in (
            ("ring", long_losses, SP_CHANGE_TOL, SP_LOSS_TOL),
            ("ulysses", long_losses, SP_CHANGE_TOL, SP_LOSS_TOL),
            ("ring_control", long_losses, SP_CHANGE_TOL, SP_LOSS_TOL),
            ("ep", ep_losses, EP_CHANGE_TOL, EP_LOSS_TOL),
            ("ep_control", ep_losses, EP_CHANGE_TOL, EP_LOSS_TOL)):
        r0, r1 = two[0][name], two[1][name]
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want))
        # Every gradient but an expert's own is averaged over seq and
        # expert, so the ranks hold one model bit for bit.
        apart = [n for n in r0["sums"] if r0["sums"][n] != r1["sums"][n]]
        gap = max(r0["gap"], r1["gap"])
        control = name.endswith("control")
        print(f"seq_expert_two_ranks {name}: {r0['seconds']:.1f} s; losses "
              f"equal on both ranks {r0['losses'] == r1['losses']}, parameters "
              f"apart {apart[:3]}{' ...' if len(apart) > 3 else ''} "
              f"({len(apart)}); losses " + " ".join(f"{x:.6f}" for x in r0["losses"])
              + f"; max rel loss gap {loss_gap:.3e} (tol {loss_tol:g}); rel L2 "
              f"of the parameter change against one process {r0['gap']:.3e} "
              f"(rank 1 {r1['gap']:.3e}) "
              f"(tol {change_tol:g}{', must exceed it' if control else ''}); "
              f"rank launches {r0['launches']}", flush=True)
        if r0["losses"] != r1["losses"] or apart:
            failures.append(f"{name}: the two ranks disagree")
        per_run = SP_EP_LAYERS * LONG_STEPS if name.startswith("ep") else 0
        want_launches = {k: per_run for k in r0["launches"]}
        want_launches["flash_decode"] = 0
        for r, rank in enumerate((r0, r1)):
            if rank["launches"] != want_launches:
                failures.append(f"{name}: rank {r} launched {rank['launches']}, "
                                f"want {want_launches}")
        if not np.isfinite(r0["losses"]).all():
            failures.append(f"{name}: losses {r0['losses']}")
        if control and min(r0["gap"], r1["gap"]) <= change_tol:
            failures.append(f"{name}: the control stays within {change_tol:g}")
        if not control and (gap > change_tol or loss_gap > loss_tol):
            failures.append(f"{name}: gap {gap:.3e}, loss gap {loss_gap:.3e}")
    if two[0]["ring"]["batch_partition"] != {"input_ids": ("data", "seq"),
                                             "attention_mask": ("data", "seq")}:
        failures.append(f"batch_partition {two[0]['ring']['batch_partition']}")
    launches = {k: sum(rank[name]["launches"][k] for rank in two
                       for name in ("ring", "ulysses", "ep"))
                for k in two[0]["ep"]["launches"]}
    return launches, failures


# ---- 8d. tensor and pipeline parallelism on two gloo ranks (A6b)

TP_VOCAB = 30522             # BASELINE configs[3]: BERT-base's own vocabulary
# The tensor-parallel BERT-base runs' depth: 6 of its 12 layers (cut for
# the script's time limit, PR 21).
TP_LAYERS = 6
TP_BATCH = 32
TP_STEPS = 3
TP_RUN_FN_ROWS = 128
# The staged classifier at BERT width: 2 stages x 6 layers, 8 microbatches
# of 32 at L = 128, f32 (the reference's staged dtype).
PP_HP = {"vocab_size": TP_VOCAB, "d_model": 768, "n_heads": 12, "head_dim": 64,
         "d_ff": 3072, "max_len": SEQ_LEN, "num_classes": 4, "n_stages": 2,
         "layers_per_stage": 6, "num_microbatches": 8, "dtype": "float32",
         "learning_rate": LONG_LR, "batch_size": 8 * 32}
PP_STEPS = 3
PP_PREDICT_ROWS = 16
# Two ranks against one process, SGD (LONG_LR) over 3 steps, dropout 0:
# the relative L2 distance of the parameter changes from the shared init,
# and each step's relative loss gap, on both ranks (change_gap).  Tensor
# parallelism is held in f32 compute on both sides, where a rank's partial
# sums (half the heads of attention's output projection, half the MLP
# columns) differ from one process's GEMMs in their order alone, and in
# bf16 (BERT's own path: the tensor-core kernels, the bf16 casts of the
# row-parallel products) against one process in bf16, each with a
# control (rank-local partial products of layer 0's attention output,
# its reduction over ``model`` left out) that must miss.  Predicted
# before the first run on the card: f32 gaps near the sequence-parallel
# runs' 2e-5, the control above 3e-3 (5.1e-3 on the CPU at a tiny width,
# against 6.4e-7 sound).  The pipeline's sequential oracle runs the same
# f32 math on the whole batch where the stages see microbatches of 32:
# predicted gap 1e-6 to 1e-5, its control (stage 1 handed the previous
# tick's microbatch) above 1e-1.  Each tolerance sits between.  Measured
# on one H100 80GB HBM3 (700 W) at --seed 0: TP f32 1.080e-5, its control
# 1.819e-1 (loss gaps 1.2e-7 and 1.8e-2); TP bf16 1.071e-2, its control
# 1.830e-1 (loss gaps 1.16e-3 and 1.87e-2), from which the bf16
# tolerances were set; PP 3.059e-6, its control 2.218e-1; the staged
# payload 9.5e-7 from one process's logits.
TP_LOSS_TOL = 1e-4
TP_CHANGE_TOL = 3e-4
TP_BF16_LOSS_TOL = 5e-3
TP_BF16_CHANGE_TOL = 5e-2
PP_LOSS_TOL = 1e-4
PP_CHANGE_TOL = 1e-3
# The exported staged payload (no mesh, the stages in order) against the
# one-process model's logits: f32 on both sides, trained apart by the gaps
# above.
PP_LOGIT_TOL = 1e-3


def tp_hparams(dropout=0.0):
    return {**DEFAULT_HPARAMS, "vocab_size": TP_VOCAB, "attn_impl": "flash",
            "max_len": SEQ_LEN, "num_classes": 2, "dropout_rate": dropout,
            "batch_size": TP_BATCH, "n_layers": TP_LAYERS}


def tp_batches(seed, n=TP_STEPS):
    return training_batches(seed + 37, TP_VOCAB, n, batch=TP_BATCH, length=SEQ_LEN)


def tp_partition(hp):
    from tpu_pipelines_torch.parallel.partition import (
        bert_partition_rules,
        make_param_partition,
    )

    with torch.device("meta"):
        return make_param_partition(build_bert_model(hp), bert_partition_rules())


def pp_batches(seed, n=PP_STEPS):
    rng = np.random.default_rng(seed + 41)
    out = []
    for _ in range(n):
        tokens = rng.integers(2, TP_VOCAB, size=(PP_HP["batch_size"], SEQ_LEN))
        out.append({"tokens": tokens.astype(np.int64),
                    "label": (tokens[:, 0] % PP_HP["num_classes"]).astype(np.int64)})
    return out


def pp_predict_tokens(seed):
    rng = np.random.default_rng(seed + 43)
    return rng.integers(2, TP_VOCAB, size=(PP_PREDICT_ROWS, SEQ_LEN)).astype(np.int64)


def pp_build(mesh):
    from tpu_pipelines_torch.models.staged import (
        build_staged_model,
        init_staged_weights,
    )

    return lambda generator, batch: init_staged_weights(
        build_staged_model(PP_HP, mesh=mesh), generator)


def pp_partition():
    from tpu_pipelines_torch.models.staged import (
        build_staged_model,
        staged_partition_rules,
    )
    from tpu_pipelines_torch.parallel.partition import make_param_partition

    with torch.device("meta"):
        return make_param_partition(build_staged_model(PP_HP),
                                    staged_partition_rules())


def step_ms(times):
    """The median host ms between consecutive step ends (the first step,
    with its warm-up or capture, excluded)."""
    gaps = np.diff(np.asarray(times)) * 1e3
    return float(np.median(gaps)) if len(gaps) else float("nan")


def leave_out_first_attention_reduction(model):
    """The tensor-parallel control: layer 0's attention output is the
    rank's partial product alone, its reduction over ``model`` left out."""
    attn = model.encoder.layers[0].attn

    def partial(out):
        b, l = out.shape[:2]
        return tfm._dense(out.reshape(b, l, -1), attn.out, attn.dtype)

    attn._project_out = partial


def _held_shapes(model, names):
    return {n: tuple(p.shape) for n, p in model.named_parameters() if n in names}


def _tp_job(seed, *, want_path, f32, control=False):
    """One rank of BERT-base (12 x 64 heads, d_ff 3072, vocabulary 30,522,
    TP_LAYERS layers) at TP_BATCH x SEQ_LEN over data = 1 x model = 2 with
    flash attention,
    dropout 0, TP_STEPS SGD steps through train_loop with
    ``bert_partition_rules`` (f32 compute with ``f32``, else bf16).  The
    control leaves layer 0's attention-output reduction out."""
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    zero_counters()
    mesh = make_mesh({"data": 1, "model": 2}, device=DEVICE)
    hp = tp_hparams()
    held = {}
    names = ("encoder.embed.weight", "encoder.layers.0.attn.query.weight",
             "encoder.layers.0.attn.out.weight", "encoder.layers.0.mlp.wi.weight")

    def hook(model):
        held.update(_held_shapes(model, names))
        if control:
            leave_out_first_attention_reduction(model)

    times = []
    t0 = time.perf_counter()
    model, losses, result, start = parallel_run(
        hp, seed, tp_batches(seed), mesh, f32=f32, param_partition=tp_partition(hp),
        hook=hook, step_times=times)
    seconds = time.perf_counter() - t0
    return {"losses": losses, "sums": _sums(model), "seconds": seconds,
            "gap": change_gap(model, start, want_path),
            "held": held, "step_ms": step_ms(times),
            "step_capture": result.step_capture, "launches": by_record(counters())}


def _tp_run_fn_job(seed, *, examples, out_dir, batch):
    """One rank of ``bert_module.run_fn`` at BERT-base (vocabulary 30,522,
    flash, dropout 0.1) on ``mesh_config {"data": 1, "model": 2}``: the
    losses, the returned (gathered) model's sums and its eval-mode logits
    of ``batch``, and on rank 0 the exported payload's, loaded with no
    mesh."""
    from tpu_pipelines_torch.trainer.fn_args import FnArgs

    zero_counters()
    losses, seen = [], {}
    real = bert_module.train_loop

    def recording(**kwargs):
        kwargs["metrics_cb"] = lambda s, m: losses.append(m["loss"])
        seen["model"], result = real(**kwargs)
        return seen["model"], result

    serving = os.path.join(out_dir, "model")
    with mock.patch.object(bert_module, "train_loop", recording):
        result = bert_module.run_fn(FnArgs(
            train_examples_uri=examples, eval_examples_uri=examples,
            serving_model_dir=serving, model_run_dir=os.path.join(out_dir, "run"),
            train_steps=TP_STEPS, hyperparameters=tp_hparams(dropout=0.1),
            mesh_config={"data": 1, "model": 2},
            custom_config={"train_loop": {"log_every": 1, "window_steps": 1}},
            device=DEVICE))
    model = seen["model"].eval()
    features = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    with torch.no_grad():
        logits = model(features).float().cpu()
    out = {"losses": losses, "sums": _sums(model), "logits": logits,
           "steps_completed": result.steps_completed,
           "launches": by_record(counters())}
    if torch.distributed.get_rank() == 0:
        loaded = load_exported_model(serving, device=DEVICE)
        out["payload_logits"] = torch.as_tensor(loaded.predict(batch)).float()
    return out


def _stage_elements(model):
    return sum(p.numel() for n, p in model.named_parameters() if n.startswith("stages."))


def shifting_stage_1_by_a_microbatch():
    """The pipeline control: pipe rank 1 is handed, at each tick, what
    stage 0 sent the tick before (every rank still exchanges at every
    tick, so the backward stays matched)."""
    from tpu_pipelines_torch.parallel import collectives

    real = collectives.ppermute
    ticks = PP_HP["num_microbatches"] + PP_HP["n_stages"] - 2
    held = {"calls": 0}

    def shifted(x, perm, group):
        got = real(x, perm, group)
        if held["calls"] % ticks == 0:
            held.pop("prev", None)
        held["calls"] += 1
        if torch.distributed.get_rank(group) != 1:
            return got
        prev = held.get("prev", got)
        held["prev"] = got
        # got stays in the graph (a zero gradient), so that this exchange's
        # backward runs on this rank too.
        return prev + 0 * got

    return mock.patch.object(collectives, "ppermute", shifted)


def _pp_job(seed, *, want_path, out_dir, control=False):
    """One rank of the staged classifier at BERT width (PP_HP) over data =
    1 x pipe = 2, PP_STEPS SGD steps through train_loop with
    ``staged_partition_rules``: the stage shapes it held while training,
    the losses and parameter change against the sequential run, and on
    rank 0 the exported payload (no mesh): its stage dims and its
    predictions of the PP_PREDICT_ROWS rows."""
    from tpu_pipelines_torch.examples import staged_module
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    zero_counters()
    mesh = make_mesh({"data": 1, "pipe": 2}, device=DEVICE)
    held = {}

    def hook(model):
        held["stages"] = sorted({tuple(p.shape)[0] for n, p in model.named_parameters()
                                 if n.startswith("stages.")})
        held["stage_elements"] = _stage_elements(model)

    times = []
    t0 = time.perf_counter()
    with (shifting_stage_1_by_a_microbatch() if control
          else contextlib.nullcontext()):
        model, losses, result, start = parallel_run(
            PP_HP, seed, pp_batches(seed), mesh, loss_fn=staged_module.loss_fn,
            param_partition=pp_partition(), build=pp_build(mesh), hook=hook,
            step_times=times)
    seconds = time.perf_counter() - t0
    out = {"losses": losses, "sums": _sums(model), "seconds": seconds,
           "gap": change_gap(model, start, want_path), "held": held,
           "whole_stage_elements": _stage_elements(model),
           "step_ms": step_ms(times), "step_capture": result.step_capture,
           "launches": by_record(counters())}
    if torch.distributed.get_rank() == 0 and not control:
        export_model(serving_model_dir=out_dir, params=model.state_dict(),
                     module_file=staged_module.__file__, hyperparameters=PP_HP)
        loaded = load_exported_model(out_dir, device=DEVICE)
        out["payload_stages"] = sorted({tuple(v.shape)[0] for k, v in loaded.params.items()
                                        if k.startswith("stages.")})
        out["payload_logits"] = torch.as_tensor(
            loaded.predict({"tokens": pp_predict_tokens(seed)})).float()
    return out


def tp_run_fn_examples(root, seed):
    """A two-shard examples artifact of TP_RUN_FN_ROWS rows for the BERT
    module (train and eval splits alike) and a batch of 8 of them."""
    from tpu_pipelines_torch.data import examples_io

    data = training_batches(seed + 47, TP_VOCAB, 1, batch=TP_RUN_FN_ROWS,
                            length=SEQ_LEN)[0]
    examples = os.path.join(root, "examples")
    for split in ("train", "eval"):
        examples_io.write_split(examples, split,
                                examples_io.table_from_columns(data), num_shards=2)
    return examples, {k: v[:8] for k, v in data.items() if k != "label"}


def staged_dag_phase(card, workdir):
    """(d) The staged DAG twin through ``python -m tpu_pipelines_torch run``
    in this process at its defaults: one process is fewer than its data 2
    x pipe 4, so the reference's fallback runs (plain data parallelism,
    the stages in order); cold then warm, no attention kernel."""
    from tpu_pipelines_torch.examples import staged_pipeline

    base = os.path.join(workdir, "staged")
    module = os.path.join(staged_pipeline.HERE, "staged_pipeline.py")

    def run_once():
        with mock.patch.dict(os.environ, {"TPP_PIPELINE_HOME": base}):
            code, out = cli(["run", "--pipeline-module", module, "--device", DEVICE])
        if code != 0:
            raise AssertionError(f"staged_dag: run exited {code}: {out[-2000:]}")

    cold, cold_s, warm, warm_s, launches, seen = run_dag(
        "staged_dag", run_once, os.path.join(staged_pipeline.HERE, "staged_module.py"))
    if any(launches.values()):
        raise AssertionError(f"staged_dag: launches {launches}")
    result = seen["result"]
    if not np.isfinite(seen["losses"]).all() or result.steps_completed != 60:
        raise AssertionError(f"staged_dag: {result.steps_completed} steps, losses "
                             f"{seen['losses'][:3]} ...")
    print(f"tp_pp_two_ranks (d) staged DAG [{card}]: `python -m "
          f"tpu_pipelines_torch run` at its defaults (one process: the "
          f"sequential fallback) cold {cold_s:.1f} s: " + ", ".join(
              f"{k} {v.wall_clock_s:.2f} s" for k, v in cold.nodes.items())
          + f"; {result.steps_completed} steps, losses {seen['losses'][0]:.4f} -> "
          f"{seen['losses'][-1]:.4f}, {seen['captures']} capture, "
          f"{seen['replays']} replays, {result.examples_per_sec:.1f} examples/s; "
          f"warm run {warm_s:.2f} s, all {len(cold.nodes)} CACHED, no kernel "
          "launched", flush=True)


def two_rank_jobs(seed, card, setups):
    """Each of ``setups`` (``setup(seed, card, tmp) -> (jobs, finish)``: its
    one-process runs, then its jobs) in turn, deterministic cuBLAS, then
    every job in one spawn of two gloo ranks of the card, one job at a
    time; returns each ``finish(two, seconds)``."""
    tmp = tempfile.mkdtemp()
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        made = [setup(seed, card, tmp) for setup in setups]
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        two = dp_spawn(2, DP_TWO_BACKEND, seed,
                       [job for jobs, _ in made for job in jobs])
        two_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
    return [finish(two, two_s) for _, finish in made]


def tp_pp_setup(seed, card, tmp):
    """(8d) tp_pp_two_ranks: tensor and pipeline parallelism (A6b) on two
    gloo ranks of the one card (NCCL refuses two ranks on one device;
    gloo carries all_reduce, all_gather and all_to_all_single on CUDA
    tensors), one job at a time, each job's launches counted from zero on
    its ranks, each held against one process running the same steps: (a)
    BERT-base over model = 2 in f32 and in bf16, each with a control; (b)
    ``bert_module.run_fn`` on that mesh at dropout 0.1, its payload loaded
    with no mesh; (c) the staged classifier at BERT width over pipe = 2
    (parity, a control, the payload).  Returns the one-process runs' rank
    jobs and ``finish(two, seconds)`` -> ({"tp": [rank 0's, rank 1's
    launches of the bf16 run], "pp": [...]}, the failures);
    ``two_rank_jobs`` runs them."""
    zero_counters()
    one, paths = {}, {}
    for name, f32 in (("tp_f32", True), ("tp_bf16", False)):
        times = []
        t0 = time.perf_counter()
        model, losses, result, _ = parallel_run(
            tp_hparams(), seed, tp_batches(seed), step_times=times, f32=f32)
        one[name] = {"losses": losses, "step_ms": step_ms(times),
                     "seconds": time.perf_counter() - t0,
                     "step_capture": result.step_capture}
        paths[name] = os.path.join(tmp, f"{name}.pt")
        torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
                   paths[name])
        del model
    from tpu_pipelines_torch.examples import staged_module

    times = []
    t0 = time.perf_counter()
    model, losses, result, _ = parallel_run(
        PP_HP, seed, pp_batches(seed), loss_fn=staged_module.loss_fn,
        build=pp_build(None), step_times=times)
    with torch.no_grad():
        pp_logits = model.eval()(torch.as_tensor(pp_predict_tokens(seed),
                                                 device=DEVICE)).float().cpu()
    one["pp"] = {"losses": losses, "step_ms": step_ms(times),
                 "seconds": time.perf_counter() - t0,
                 "step_capture": result.step_capture}
    paths["pp"] = os.path.join(tmp, "pp.pt")
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
               paths["pp"])
    del model
    one_launches = by_record(counters())
    examples, batch = tp_run_fn_examples(tmp, seed)
    jobs = [("tp_f32", "tp", {"want_path": paths["tp_f32"], "f32": True}),
            ("tp_f32_control", "tp", {"want_path": paths["tp_f32"], "f32": True,
                                      "control": True}),
            ("tp_bf16", "tp", {"want_path": paths["tp_bf16"], "f32": False}),
            ("tp_bf16_control", "tp", {"want_path": paths["tp_bf16"], "f32": False,
                                       "control": True}),
            ("run_fn", "tp_run_fn", {"examples": examples, "batch": batch,
                                     "out_dir": os.path.join(tmp, "run_fn")}),
            ("pp", "pp", {"want_path": paths["pp"],
                          "out_dir": os.path.join(tmp, "pp_model")}),
            ("pp_control", "pp", {"want_path": paths["pp"], "control": True,
                                  "out_dir": os.path.join(tmp, "pp_control")})]
    return jobs, functools.partial(_tp_pp_finish, card, one, one_launches, pp_logits)


def _tp_pp_finish(card, one, one_launches, pp_logits, two, two_s):
    failures = []
    print(f"tp_pp_two_ranks [{card}]: one process ({one['tp_f32']['step_capture']}): "
          f"BERT-base (vocabulary {TP_VOCAB}, {TP_LAYERS} layers) flash at "
          f"{TP_BATCH} x {SEQ_LEN}, "
          f"f32 losses " + " ".join(f"{x:.6f}" for x in one["tp_f32"]["losses"])
          + f", step {one['tp_f32']['step_ms']:.1f} ms; bf16 losses "
          + " ".join(f"{x:.6f}" for x in one["tp_bf16"]["losses"])
          + f", step {one['tp_bf16']['step_ms']:.1f} ms; the staged classifier "
          f"(d_model 768, 2 x 6 layers, batch {PP_HP['batch_size']}, f32) in "
          "order, losses " + " ".join(f"{x:.6f}" for x in one["pp"]["losses"])
          + f", step {one['pp']['step_ms']:.1f} ms; launches {one_launches} (the "
          "one-process runs', not the ranks')", flush=True)
    print(f"tp_pp_two_ranks: two ranks over {DP_TWO_BACKEND} on one card "
          f"({two[0]['tp_f32']['step_capture']}), {two_s:.1f} s", flush=True)
    per_run = {k: TP_LAYERS * TP_STEPS for k in two[0]["tp_f32"]["launches"]}
    per_run["flash_decode"] = 0
    nothing = dict.fromkeys(per_run, 0)
    d, ff = DEFAULT_HPARAMS["d_model"], DEFAULT_HPARAMS["d_ff"]
    half = {"encoder.embed.weight": (TP_VOCAB // 2, d),
            "encoder.layers.0.attn.query.weight": (d // 2, d),
            "encoder.layers.0.attn.out.weight": (d, d // 2),
            "encoder.layers.0.mlp.wi.weight": (ff // 2, d)}
    for name, want, change_tol, loss_tol in (
            ("tp_f32", one["tp_f32"], TP_CHANGE_TOL, TP_LOSS_TOL),
            ("tp_f32_control", one["tp_f32"], TP_CHANGE_TOL, TP_LOSS_TOL),
            ("tp_bf16", one["tp_bf16"], TP_BF16_CHANGE_TOL, TP_BF16_LOSS_TOL),
            ("tp_bf16_control", one["tp_bf16"], TP_BF16_CHANGE_TOL,
             TP_BF16_LOSS_TOL),
            ("pp", one["pp"], PP_CHANGE_TOL, PP_LOSS_TOL),
            ("pp_control", one["pp"], PP_CHANGE_TOL, PP_LOSS_TOL)):
        r0, r1 = two[0][name], two[1][name]
        apart = [n for n in r0["sums"] if r0["sums"][n] != r1["sums"][n]]
        control = name.endswith("control")
        held = (f"{r0['seconds']:.1f} s, step {r0['step_ms']:.1f} ms over gloo on "
                f"one card; losses equal on both ranks {r0['losses'] == r1['losses']}, "
                f"parameters apart {apart[:3]} ({len(apart)}); losses "
                + " ".join(f"{x:.6f}" for x in r0["losses"]))
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(r0["losses"], want["losses"]))
        gap = max(r0["gap"], r1["gap"])
        print(f"tp_pp_two_ranks {name}: {held} (one process step "
              f"{want['step_ms']:.1f} ms); max rel loss gap {loss_gap:.3e} "
              f"(tol {loss_tol:g}); rel L2 of the parameter change against "
              f"one process {r0['gap']:.3e} (rank 1 {r1['gap']:.3e}) (tol "
              f"{change_tol:g}" + (", must exceed it" if control else "")
              + f"); held while training {r0['held']}; rank launches "
              f"{r0['launches']} / {r1['launches']}", flush=True)
        if r0["losses"] != r1["losses"] or apart:
            failures.append(f"{name}: the two ranks disagree")
        if not np.isfinite(r0["losses"]).all():
            failures.append(f"{name}: losses {r0['losses']}")
        want_launches = per_run if name.startswith("tp") else nothing
        for r, rank in enumerate((r0, r1)):
            if rank["launches"] != want_launches:
                failures.append(f"{name}: rank {r} launched {rank['launches']}, "
                                f"want {want_launches}")
        if name.startswith("tp") and r0["held"] != half:
            failures.append(f"{name}: rank 0 held {r0['held']}, want {half}")
        if name.startswith("pp") and (
                r0["held"]["stages"] != [1]
                or 2 * r0["held"]["stage_elements"] != r0["whole_stage_elements"]):
            failures.append(f"{name}: rank 0 held {r0['held']} of "
                            f"{r0['whole_stage_elements']} stage elements")
        if control and min(r0["gap"], r1["gap"]) <= change_tol:
            failures.append(f"{name}: the control stays within {change_tol:g}")
        if not control and (gap > change_tol or loss_gap > loss_tol):
            failures.append(f"{name}: gap {gap:.3e}, loss gap {loss_gap:.3e}")

    r0, r1 = two[0]["run_fn"], two[1]["run_fn"]
    apart = [n for n in r0["sums"] if r0["sums"][n] != r1["sums"][n]]
    payload_gap = float((r0["payload_logits"] - r0["logits"]).abs().max())
    print(f"tp_pp_two_ranks (b) bert_module.run_fn on model = 2, dropout 0.1: "
          f"{r0['steps_completed']} steps, losses equal on both ranks "
          f"{r0['losses'] == r1['losses']} (" + " ".join(f"{x:.6f}" for x in r0["losses"])
          + f"), parameters apart {len(apart)}, launches {r0['launches']} / "
          f"{r1['launches']}; rank 0's payload (no mesh) against the gathered "
          f"model's logits: max |diff| {payload_gap:.3e} (tol {LOGIT_TOL:g})",
          flush=True)
    if r0["losses"] != r1["losses"] or apart or r0["steps_completed"] != TP_STEPS:
        failures.append("run_fn: the two ranks disagree")
    if not torch.equal(r0["logits"], r1["logits"]) or payload_gap > LOGIT_TOL:
        failures.append(f"run_fn: payload gap {payload_gap:.3e}")
    for r, rank in enumerate((r0, r1)):
        if rank["launches"]["flash_bwd_dq"] != TP_LAYERS * TP_STEPS:
            failures.append(f"run_fn: rank {r} launched {rank['launches']}")

    pp = two[0]["pp"]
    pred_gap = float((pp["payload_logits"] - pp_logits).abs().max())
    print(f"tp_pp_two_ranks (c) rank 0's staged payload (no mesh): stages "
          f"{pp['payload_stages']} a leading dim, predictions of "
          f"{PP_PREDICT_ROWS} rows against the one-process model's: max |diff| "
          f"{pred_gap:.3e} (tol {PP_LOGIT_TOL:g})", flush=True)
    if pp["payload_stages"] != [PP_HP["n_stages"]] or pred_gap > PP_LOGIT_TOL:
        failures.append(f"pp payload: stages {pp['payload_stages']}, gap {pred_gap:.3e}")
    return ({"tp": [two[0]["tp_bf16"]["launches"], two[1]["tp_bf16"]["launches"]],
             "pp": [two[0]["pp"]["launches"], two[1]["pp"]["launches"]]}, failures)


# ---- 8e. T5 and the MoE experts on the other mesh axes (A6c)

# T5-small (configs[4]'s geometry: d_model 512, 8 x 64 heads, d_ff 2048,
# vocabulary 32,128) trained over model = 2 and on a split sequence, and
# decoded over model = 2; BERT-base-MoE with its experts' ff dim over
# model = 2.  Depths cut for the script's time (PERF.md section 4).
T5_TP_LAYERS = 2             # encoder and decoder layers of the training jobs
T5_TP_BATCH = 32
T5_TP_LEN = 128
T5_SP_LEN = 1024
T5_SP_BATCH = 4
# The decoding job's depth: 2 + 2 of T5-small's 6 + 6 layers (cut for the
# script's time limit, PR 21; a rank's decode step is gloo's latency).
T5_DECODE_LAYERS = 2
T5_DECODE_ROWS = 8
T5_DECODE_STEPS = 32
T5_DECODE_CACHE = 2048
T5_BEAM_ROWS = 4
T5_BEAM_STEPS = 32
# The T5 training jobs' parameter-change limit over model = 2.  T5's f32
# runs read 10x BERT's (1.3e-4 against 1.1e-5): its change is small beside
# its unit-scale embedding, so f32's grid rounds the change coarsely (the
# one-process f64 run printed beside the reading is the witness: the f32
# change is about 8e-3 from it, NVIDIA H100 80GB HBM3, 700.00 W), and two
# f32 runs, which share that grid, part where a last bit flips.  The limit
# sits between the sound readings and the controls' (above 0.2).
T5_CHANGE_TOL = 1e-3


def t5_two_rank_hparams(dropout=0.0, layers=T5_TP_LAYERS):
    return {**t5m.DEFAULT_HPARAMS, "n_layers": layers, "dropout_rate": dropout,
            "attn_impl": "flash", "batch_size": T5_TP_BATCH}


def t5_batches(seed, n, batch, length):
    """``n`` T5 batches: inputs and targets of ``length`` with ragged real
    lengths (pad 0 behind), the input mask."""
    rng = np.random.default_rng(seed + 53)
    vocab = t5m.DEFAULT_HPARAMS["vocab_size"]
    out = []
    for _ in range(n):
        ids = []
        for _ in range(2):
            lengths = rng.integers(8, length + 1, size=batch)
            mask = np.arange(length)[None, :] < lengths[:, None]
            ids.append(np.where(mask, rng.integers(2, vocab, size=(batch, length)), 0))
        out.append({"inputs": ids[0].astype(np.int32),
                    "targets": ids[1].astype(np.int32),
                    "input_mask": (ids[0] > 0).astype(np.int32)})
    return out


def from_saved_init(make, path):
    """A ``build(generator, batch)`` for ``parallel_run``: ``make()`` (a
    model, built on a mesh or not) holding the whole initial state saved
    at ``path`` (its rank's slices of it), drawn once for every run of a
    job and its one-process baseline."""
    def build(generator, batch):
        model = make()
        model.load_state_dict(torch.load(path, weights_only=True))
        return model

    return build


def save_init(model, path):
    torch.save(model.state_dict(), path)
    return path


def cross_attending_the_own_block():
    """The split-sequence control: cross-attention's gather of the encoder
    output over seq is left out (each rank's queries see its own block of
    the encoder, repeated to the whole length; the exchange still runs and
    stays in the graph)."""
    from tpu_pipelines_torch.parallel import collectives

    real_forward, real_gather = tfm.MultiHeadAttention.forward, collectives.all_gather
    cross = {"on": False}

    def forward(self, x, *args, x_kv=None, **kwargs):
        cross["on"] = x_kv is not None
        try:
            return real_forward(self, x, *args, x_kv=x_kv, **kwargs)
        finally:
            cross["on"] = False

    def gather(x, dim, group):
        got = real_gather(x, dim, group)
        if not cross["on"]:
            return got
        own = torch.cat([x] * (got.shape[dim] // x.shape[dim]), dim=dim)
        return own + 0 * got if got.is_floating_point() else own

    return [mock.patch.object(tfm.MultiHeadAttention, "forward", forward),
            mock.patch.object(collectives, "all_gather", gather)]


def leave_out_first_moe_reduction(model):
    """The MoE control: layer 1's expert output leaves without its
    reduction over ``model`` (each rank keeps its columns' partial sum)."""
    from tpu_pipelines_torch.parallel import collectives
    from tpu_pipelines_torch.parallel.partition import slice_group

    moe = model.encoder.layers[1].moe
    group, real, forward = slice_group(moe, "wi"), collectives.leave_partial, moe.forward

    def partial(x, g):
        return x if g is group else real(x, g)

    def patched(*args, **kwargs):
        with mock.patch.object(collectives, "leave_partial", partial):
            return forward(*args, **kwargs)

    moe.forward = patched


def draw_own_columns(model):
    """The dropout control: each rank draws the mask of its own d_ff
    columns alone (the hidden site forgets its split), so the ranks draw
    the same numbers for different columns."""
    for module in model.modules():
        if isinstance(module, tfm.Dropout):
            module.columns = None


def _t5_train_job(seed, *, want_path, init_path, mesh_config, split=False,
                  dropout=0.0, control=None, f64_path=None):
    """One rank of T5-small (T5_TP_LAYERS + T5_TP_LAYERS layers, f32, 3 SGD
    steps through train_loop with ``t5_module.loss_fn``) on
    ``mesh_config``: over model with ``t5_partition_rules`` at 32 x 128,
    or on seq with its inputs and targets split (``split``) at 4 x 1024,
    from the initial weights at ``init_path``; with ``f64_path``, also
    its distance from the one-process f64 run saved there.
    ``control``: "reduction" (layer 0's attention-output reduction left
    out), "cross" (cross-attention's gather left out) or "draw" (each
    rank draws its columns' dropout mask alone)."""
    from tpu_pipelines_torch.parallel.mesh import make_mesh
    from tpu_pipelines_torch.parallel.partition import (
        make_param_partition,
        t5_partition_rules,
    )
    from tpu_pipelines_torch.parallel.ring_attention import (
        long_context_batch_partition,
    )

    zero_counters()
    mesh = make_mesh(mesh_config, device=DEVICE)
    hp = t5_two_rank_hparams(dropout)
    batches = (t5_batches(seed, LONG_STEPS, T5_SP_BATCH, T5_SP_LEN) if split
               else t5_batches(seed, TP_STEPS, T5_TP_BATCH, T5_TP_LEN))
    bp = long_context_batch_partition(batches[0], mesh) if split else None
    with torch.device("meta"):
        partition = make_param_partition(t5m.build_t5_model(hp), t5_partition_rules())
    held = {}
    names = ("shared.weight", "encoder.rel_pos.rel_embedding",
             "decoder.layers.0.cross.query.weight", "encoder.layers.0.mlp.wi.weight")

    def hook(model):
        held.update(_held_shapes(model, names))
        if control == "reduction":
            leave_out_first_attention_reduction(model)
        if control == "draw":
            draw_own_columns(model)

    patches = cross_attending_the_own_block() if control == "cross" else []
    times = []
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        model, losses, result, start = parallel_run(
            hp, seed, batches, mesh, batch_partition=bp, loss_fn=t5_module.loss_fn,
            f32=True, param_partition=partition, hook=hook, step_times=times,
            build=from_saved_init(lambda: t5m.build_t5_model(hp, mesh=mesh), init_path))
    seconds = time.perf_counter() - t0
    return {"losses": losses, "sums": _sums(model), "seconds": seconds,
            "gap": change_gap(model, start, want_path), "held": held,
            "gap_f64": change_gap(model, start, f64_path) if f64_path else None,
            "step_ms": step_ms(times), "step_capture": result.step_capture,
            "batch_partition": bp, "launches": by_record(counters())}


T5_DECODE_HP = {"n_layers": T5_DECODE_LAYERS, "attn_impl": "flash",
                "dropout_rate": 0.0}


def t5_decode_model(init_path, mesh):
    """T5-small at T5_DECODE_LAYERS + T5_DECODE_LAYERS layers, bf16, flash
    decode, holding the random weights saved at ``init_path``, on the
    card, eval mode."""
    hp = {**t5m.DEFAULT_HPARAMS, **T5_DECODE_HP}
    model = from_saved_init(lambda: t5m.build_t5_model(hp, mesh=mesh), init_path)(
        None, None)
    return model.to(DEVICE).eval()


def t5_decode_prompts(seed):
    rng = np.random.default_rng(seed + 61)
    vocab = t5m.DEFAULT_HPARAMS["vocab_size"]
    lengths = rng.integers(16, T5_TP_LEN + 1, size=T5_DECODE_ROWS)
    mask = np.arange(T5_TP_LEN)[None, :] < lengths[:, None]
    inputs = np.where(mask, rng.integers(2, vocab, size=(T5_DECODE_ROWS, T5_TP_LEN)), 0)
    return (torch.as_tensor(inputs, device=DEVICE),
            torch.as_tensor(mask.astype(np.int32), device=DEVICE))


@torch.no_grad()
def t5_decode_run(model, inputs, mask, beam=True):
    """Greedy, T5_DECODE_STEPS tokens for every prompt into a
    T5_DECODE_CACHE-key cache (the greedy step: one position for every
    row, the bias row [1, H, 1, L]), its logits at every step; and, with
    ``beam``, beam T5_BEAM_STEPS x 4 for the first T5_BEAM_ROWS prompts,
    with each step's top-k as the search took it (``beam_steps``: its
    candidates' scores, the chosen scores and indices; step 0's
    candidates are the first log-probabilities)."""
    params = dict(model.state_dict())
    cache, encoded, logits = t5m.prefill_decode(model, params, inputs, mask,
                                                T5_DECODE_CACHE)
    toks, steps = [], [logits.float()]
    tok = logits.argmax(dim=-1)
    for t in range(1, T5_DECODE_STEPS):
        toks.append(tok)
        cache, logits = t5m._decode_one(model, params, cache, tok, encoded, mask, t,
                                        T5_DECODE_CACHE)
        steps.append(logits.float())
        tok = logits.argmax(dim=-1)
    toks.append(tok)
    key = "decoder.layer_0.attn.cached_key"
    out = {"tokens": torch.stack(toks, 1).cpu(), "logits": torch.stack(steps, 1).cpu(),
           "heads": int(cache[key].shape[2]), "keys": int(cache[key].shape[1])}
    if beam:
        seen, real_topk = [], torch.topk

        def topk(x, k):
            got = real_topk(x, k)
            seen.append((x.float().cpu(), got.values.float().cpu(), got.indices.cpu()))
            return got

        with mock.patch.object(torch, "topk", topk):
            tokens, score = t5m.make_beam_generate(
                model, beam_size=BEAM, max_decode_len=T5_BEAM_STEPS, eos_id=EOS_ID)(
                    params, inputs[:T5_BEAM_ROWS], mask[:T5_BEAM_ROWS])
        out.update(beam=tokens.cpu(), score=score.float().cpu(), beam_steps=seen)
    return out


def decode_parity(got, want):
    """Greedy against one process: (ok, max |logit diff| through each
    row's first parting step, rows parted).  Tokens equal ``want``'s, or
    where a row parts, the one-process logits' top-2 gap at that step is
    under DECODE_LOGIT_TOL; the logits through the first parting step
    (all steps where none) within DECODE_LOGIT_TOL."""
    ok, worst, parted = True, 0.0, 0
    for r in range(want["tokens"].shape[0]):
        apart = (got["tokens"][r] != want["tokens"][r]).nonzero()
        last = int(apart[0]) if len(apart) else want["tokens"].shape[1] - 1
        diff = float((got["logits"][r, :last + 1]
                      - want["logits"][r, :last + 1]).abs().max())
        worst = max(worst, diff)
        ok = ok and diff <= DECODE_LOGIT_TOL
        if len(apart):
            parted += 1
            top2 = want["logits"][r, last].topk(2).values
            ok = ok and float(top2[0] - top2[1]) <= DECODE_LOGIT_TOL
    return ok, worst, parted


def beam_parity(got, want):
    """Beam search against one process, held as greedy is: (ok, max
    |log-prob diff| through each row's first parting step, rows parted,
    the largest near-tie gap at a parting step).  A row parts at the
    first step whose top-k picks other candidates than ``want``'s.
    Through that step the row's beams saw the same prefixes, so each
    step's log-probabilities (a candidate's score less its beam's score
    before the step; 0 apart for a finished beam, which may only pad)
    must be within DECODE_LOGIT_TOL; at it, the first differing pick
    must score within DECODE_LOGIT_TOL of ``want``'s pick among
    ``want``'s candidates (a near-tie).  A row that never parts holds
    ``want``'s tokens."""
    ok, worst, parted, tie = True, 0.0, 0, 0.0
    steps = list(zip(got["beam_steps"], want["beam_steps"]))
    for r in range(want["beam"].shape[0]):
        for t, ((g_x, _, g_i), (w_x, _, w_i)) in enumerate(steps):
            g_lp, w_lp = g_x[r], w_x[r]
            if t:
                g_lp = g_lp.view(BEAM, -1) - steps[t - 1][0][1][r][:, None]
                w_lp = w_lp.view(BEAM, -1) - steps[t - 1][1][1][r][:, None]
            diff = float((g_lp - w_lp).abs().max())
            worst = max(worst, diff)
            ok = ok and diff <= DECODE_LOGIT_TOL
            apart = (g_i[r] != w_i[r]).nonzero()
            if len(apart):
                j = int(apart[0])
                gap = float(w_x[r][w_i[r][j]] - w_x[r][g_i[r][j]])
                parted, tie = parted + 1, max(tie, gap)
                ok = ok and gap <= DECODE_LOGIT_TOL
                break
        else:
            ok = ok and torch.equal(got["beam"][r], want["beam"][r])
    return ok, worst, parted, tie


def _t5_decode_job(seed, *, want_path, init_path, control=False):
    """One rank of T5-small decoding over data = 1 x model = 2 (4 of the 8
    heads a rank, flash decode on them with the rank's bias rows), greedy
    and beam; the control leaves layer 0's attention-output reduction
    out."""
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 1, "model": 2}, device=DEVICE)
    model = t5_decode_model(init_path, mesh)
    if control:
        leave_out_first_attention_reduction(model)
    inputs, mask = t5_decode_prompts(seed)
    zero_counters()
    t0 = time.perf_counter()
    got = t5_decode_run(model, inputs, mask)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = torch.load(want_path, weights_only=True)
    ok, worst, parted = decode_parity(got, want)
    beam_ok, beam_worst, beam_parted, tie = beam_parity(got, want)
    return {"ok": ok, "worst": worst, "parted": parted, "beam_ok": beam_ok,
            "beam_worst": beam_worst, "beam_parted": beam_parted, "tie": tie,
            "beam": got["beam"], "seconds": seconds,
            "heads": got["heads"], "keys": got["keys"],
            "logits": got["logits"], "tokens": got["tokens"],
            "launches": by_record(counters())}


def _moe_tp_job(seed, *, want_path, init_path, control=False):
    """One rank of BERT-base-MoE (8 experts on the odd layers) at
    SP_EP_LAYERS layers over data = 1 x model = 2 (the experts' d_ff and
    the heads halved), f32, flash, 3 SGD steps with ``bert_partition_rules``;
    the control leaves layer 1's expert-output reduction out."""
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    zero_counters()
    mesh = make_mesh({"data": 1, "model": 2}, device=DEVICE)
    hp = moe_hparams(dropout=0.0, layers=SP_EP_LAYERS)
    held = {}

    def hook(model):
        held.update(_held_shapes(model, ("encoder.layers.1.moe.wi",
                                         "encoder.layers.1.moe.wo",
                                         "encoder.layers.0.attn.query.weight")))
        held["heads"] = model.encoder.layers[0].attn.n_heads
        if control:
            leave_out_first_moe_reduction(model)

    times = []
    t0 = time.perf_counter()
    model, losses, result, start = parallel_run(
        hp, seed, ep_batches(seed), mesh, loss_fn=moe_loss_fn, f32=True,
        param_partition=tp_partition(hp), hook=hook, step_times=times,
        build=from_saved_init(lambda: build_bert_model(hp, mesh=mesh), init_path))
    seconds = time.perf_counter() - t0
    return {"losses": losses, "sums": _sums(model), "seconds": seconds,
            "gap": change_gap(model, start, want_path), "held": held,
            "step_ms": step_ms(times), "step_capture": result.step_capture,
            "launches": by_record(counters())}


def t5_moe_setup(seed, card, tmp):
    """(8e) t5_moe_two_ranks: A6c on two gloo ranks of the one card, each
    job held against one process running the same work, each with a
    control that must miss: (a) T5-small over model = 2 (f32, 3 SGD steps,
    beside a one-process f64 run; control: layer 0's attention-output
    reduction left out); (b) the same at dropout 0.1 (the whole-shape
    draw; control: each rank draws its columns' mask alone); (c) T5-small
    decoding over model = 2 in bf16, greedy into a 2048-key cache and
    beam 4 (control: the reduction left out, which greedy and beam must
    each miss); (d) T5-small on a split sequence, seq = 2 (control:
    cross-attention's gather left out); (e) BERT-base-MoE over model = 2
    (control: layer 1's expert-output reduction left out).  Returns the
    rank jobs and ``finish(two, seconds)``; ``two_rank_jobs`` runs them in
    the shared spawn."""
    zero_counters()
    t0 = time.perf_counter()
    one, paths = {}, {}
    t5_hp, moe_hp = t5_two_rank_hparams(), moe_hparams(dropout=0.0, layers=SP_EP_LAYERS)
    inits = {
        "t5": save_init(t5m.init_t5_weights(t5m.build_t5_model(t5_hp),
                                            torch.Generator().manual_seed(seed)),
                        os.path.join(tmp, "t5_init.pt")),
        "moe_tp": save_init(init_bert_weights(build_bert_model(moe_hp),
                                              torch.Generator().manual_seed(seed)),
                            os.path.join(tmp, "moe_init.pt")),
        "t5_decode": save_init(t5m.init_t5_weights(
            t5m.build_t5_model({**t5m.DEFAULT_HPARAMS, **T5_DECODE_HP}),
            torch.Generator().manual_seed(seed + 59)), os.path.join(tmp, "t5_decode_init.pt"))}
    runs = {
        "t5_tp": (t5_two_rank_hparams(), t5_batches(seed, TP_STEPS, T5_TP_BATCH,
                                                    T5_TP_LEN), t5_module.loss_fn),
        "t5_tp_dropout": (t5_two_rank_hparams(0.1), t5_batches(
            seed, TP_STEPS, T5_TP_BATCH, T5_TP_LEN), t5_module.loss_fn),
        "t5_sp": (t5_two_rank_hparams(), t5_batches(seed, LONG_STEPS, T5_SP_BATCH,
                                                    T5_SP_LEN), t5_module.loss_fn),
        "moe_tp": (moe_hp, ep_batches(seed), moe_loss_fn),
    }
    # The witness of f32's own rounding in T5's change: (a) in one process
    # in f64 (the cross-entropy and the norms' statistics stay f32), from
    # which the one-process f32 run's distance is read below.
    t1, times = time.perf_counter(), []
    model, losses, _, _ = parallel_run(
        t5_hp, seed, runs["t5_tp"][1], loss_fn=t5_module.loss_fn, f64=True,
        build=from_saved_init(lambda: t5m.build_t5_model(t5_hp), inits["t5"]),
        step_times=times)
    paths["t5_tp_f64"] = os.path.join(tmp, "t5_tp_f64.pt")
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
               paths["t5_tp_f64"])
    one["t5_tp_f64"] = {"losses": losses, "seconds": time.perf_counter() - t1,
                        "step_ms": step_ms(times)}
    del model
    for name, (hp, batches, loss_fn) in runs.items():
        times = []
        t1 = time.perf_counter()
        if name == "moe_tp":
            build = from_saved_init(lambda: build_bert_model(moe_hp), inits["moe_tp"])
        else:
            build = from_saved_init(lambda hp=hp: t5m.build_t5_model(hp), inits["t5"])
        model, losses, result, start = parallel_run(hp, seed, batches, loss_fn=loss_fn,
                                                    f32=True, build=build,
                                                    step_times=times)
        one[name] = {"losses": losses, "step_ms": step_ms(times),
                     "seconds": time.perf_counter() - t1,
                     "step_capture": result.step_capture}
        paths[name] = os.path.join(tmp, f"{name}.pt")
        torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
                   paths[name])
        if name == "t5_tp":
            one["t5_tp_f64"]["gap_f32"] = change_gap(model, start, paths["t5_tp_f64"])
        del model
    model = t5_decode_model(inits["t5_decode"], None)
    t1 = time.perf_counter()
    decoded = t5_decode_run(model, *t5_decode_prompts(seed))
    one["t5_decode"] = {"seconds": time.perf_counter() - t1, "heads": decoded["heads"]}
    paths["t5_decode"] = os.path.join(tmp, "t5_decode.pt")
    torch.save(decoded, paths["t5_decode"])
    del model
    one_launches = by_record(counters())
    one_s = time.perf_counter() - t0
    tp, sp = {"data": 1, "model": 2}, {"data": 1, "seq": 2}
    t5, t5_sp = {"init_path": inits["t5"], "mesh_config": tp}, {
        "init_path": inits["t5"], "mesh_config": sp, "split": True}
    decode = {"want_path": paths["t5_decode"], "init_path": inits["t5_decode"]}
    moe = {"want_path": paths["moe_tp"], "init_path": inits["moe_tp"]}
    dropout = {"want_path": paths["t5_tp_dropout"], **t5, "dropout": 0.1}
    jobs = [("t5_tp", "t5_train", {"want_path": paths["t5_tp"], **t5,
                                   "f64_path": paths["t5_tp_f64"]}),
            ("t5_tp_control", "t5_train", {"want_path": paths["t5_tp"], **t5,
                                           "control": "reduction"}),
            ("t5_tp_dropout", "t5_train", dropout),
            ("t5_tp_dropout_control", "t5_train", {**dropout, "control": "draw"}),
            ("t5_decode", "t5_decode", decode),
            ("t5_decode_control", "t5_decode", {**decode, "control": True}),
            ("t5_sp", "t5_train", {"want_path": paths["t5_sp"], **t5_sp}),
            ("t5_sp_control", "t5_train", {"want_path": paths["t5_sp"], **t5_sp,
                                           "control": "cross"}),
            ("moe_tp", "moe_tp", moe),
            ("moe_tp_control", "moe_tp", {**moe, "control": True})]
    return jobs, functools.partial(_t5_moe_finish, card, one, one_launches, one_s)


def _t5_moe_finish(card, one, one_launches, one_s, two, two_s):
    failures = []
    print(f"t5_moe_two_ranks [{card}]: one process ({one['t5_tp']['step_capture']}), "
          f"{one_s:.1f} s: T5-small {T5_TP_LAYERS} + {T5_TP_LAYERS} layers f32 at "
          f"{T5_TP_BATCH} x {T5_TP_LEN}, losses "
          + " ".join(f"{x:.6f}" for x in one["t5_tp"]["losses"])
          + f", step {one['t5_tp']['step_ms']:.1f} ms; at dropout 0.1 "
          + " ".join(f"{x:.6f}" for x in one["t5_tp_dropout"]["losses"])
          + f"; at {T5_SP_BATCH} x {T5_SP_LEN} "
          + " ".join(f"{x:.6f}" for x in one["t5_sp"]["losses"])
          + f", step {one['t5_sp']['step_ms']:.1f} ms; BERT-base-MoE "
          f"{SP_EP_LAYERS} layers f32 " + " ".join(
              f"{x:.6f}" for x in one["moe_tp"]["losses"])
          + f", step {one['moe_tp']['step_ms']:.1f} ms; T5-small {T5_DECODE_LAYERS} "
          f"+ {T5_DECODE_LAYERS} bf16 decoding {one['t5_decode']['seconds']:.1f} s; "
          f"launches {one_launches} (the one-process runs', not the ranks')",
          flush=True)
    witness = one["t5_tp_f64"]
    print(f"t5_moe_two_ranks t5_tp_f64: T5-small's 3 SGD steps in one process in "
          f"f64 ({witness['seconds']:.1f} s, step {witness['step_ms']:.1f} ms), losses "
          + " ".join(f"{x:.6f}" for x in witness["losses"])
          + f"; the one-process f32 run's rel L2 parameter-change distance from "
          f"it {witness['gap_f32']:.3e} (f32's own rounding)", flush=True)
    jobs_s = sum(two[0][name].get("wall_s", 0.0) for name in two[0] if name.startswith(
        ("t5_", "moe_tp")))
    print(f"t5_moe_two_ranks: two ranks over {DP_TWO_BACKEND} on one card, the "
          f"shared spawn {two_s:.1f} s, of which this phase's jobs {jobs_s:.1f} s "
          f"(rank 0's walls); the phase's work {one_s + jobs_s:.1f} s with its "
          f"one-process runs", flush=True)
    t5_hp, heads = t5_two_rank_hparams(), t5m.DEFAULT_HPARAMS["n_heads"] // 2
    v, d, ff, h = (t5_hp[k] for k in ("vocab_size", "d_model", "d_ff", "n_heads"))
    bd, bff, bh = (DEFAULT_HPARAMS[k] for k in ("d_model", "d_ff", "n_heads"))

    def t5_shapes(n):
        return {"shared.weight": (v // n, d),
                "encoder.rel_pos.rel_embedding": (32, h // n),
                "decoder.layers.0.cross.query.weight": (d // n, d),
                "encoder.layers.0.mlp.wi.weight": (ff // n, d)}

    want_held = {
        "t5": t5_shapes(2), "t5_sp": t5_shapes(1),
        "moe": {"encoder.layers.1.moe.wi": (MOE_EXPERTS, bd, bff // 2),
                "encoder.layers.1.moe.wo": (MOE_EXPERTS, bff // 2, bd),
                "encoder.layers.0.attn.query.weight": (bd // 2, bd),
                "heads": bh // 2}}
    trains = {"flash_fwd": 0, "flash_bwd_dvec": 0, "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0, "flash_decode": 0}
    moe_runs = {**{k: SP_EP_LAYERS * LONG_STEPS for k in trains}, "flash_decode": 0}
    for name, want, change_tol, loss_tol in (
            ("t5_tp", one["t5_tp"], T5_CHANGE_TOL, TP_LOSS_TOL),
            ("t5_tp_control", one["t5_tp"], T5_CHANGE_TOL, TP_LOSS_TOL),
            ("t5_tp_dropout", one["t5_tp_dropout"], T5_CHANGE_TOL, TP_LOSS_TOL),
            ("t5_tp_dropout_control", one["t5_tp_dropout"], T5_CHANGE_TOL, TP_LOSS_TOL),
            ("t5_sp", one["t5_sp"], SP_CHANGE_TOL, SP_LOSS_TOL),
            ("t5_sp_control", one["t5_sp"], SP_CHANGE_TOL, SP_LOSS_TOL),
            ("moe_tp", one["moe_tp"], EP_CHANGE_TOL, EP_LOSS_TOL),
            ("moe_tp_control", one["moe_tp"], EP_CHANGE_TOL, EP_LOSS_TOL)):
        r0, r1 = two[0][name], two[1][name]
        apart = [n for n in r0["sums"] if r0["sums"][n] != r1["sums"][n]]
        control = name.endswith("control")
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want["losses"]))
        gap = max(r0["gap"], r1["gap"])
        print(f"t5_moe_two_ranks {name}: {r0['seconds']:.1f} s, step "
              f"{r0['step_ms']:.1f} ms over gloo (one process {want['step_ms']:.1f} "
              f"ms); losses equal on both ranks {r0['losses'] == r1['losses']}, "
              f"parameters apart {apart[:3]} ({len(apart)}); losses "
              + " ".join(f"{x:.6f}" for x in r0["losses"])
              + f"; max rel loss gap {loss_gap:.3e} (tol {loss_tol:g}); rel L2 of "
              f"the parameter change against one process {r0['gap']:.3e} (rank 1 "
              f"{r1['gap']:.3e}) (tol {change_tol:g}"
              + (", must exceed it" if control else "") + ")"
              + ("" if r0.get("gap_f64") is None else
                 f"; from the one-process f64 run {r0['gap_f64']:.3e} (the "
                 f"one-process f32 run {one['t5_tp_f64']['gap_f32']:.3e})")
              + f"; held {r0['held']}; "
              f"rank launches {r0['launches']} / {r1['launches']}", flush=True)
        if r0["losses"] != r1["losses"] or apart:
            failures.append(f"{name}: the two ranks disagree")
        if not np.isfinite(r0["losses"]).all():
            failures.append(f"{name}: losses {r0['losses']}")
        kind = ("moe" if name.startswith("moe") else
                "t5_sp" if name.startswith("t5_sp") else "t5")
        want_launches = moe_runs if kind == "moe" else trains
        for r, rank in enumerate((r0, r1)):
            if rank["launches"] != want_launches:
                failures.append(f"{name}: rank {r} launched {rank['launches']}, "
                                f"want {want_launches}")
        if r0["held"] != want_held[kind]:
            failures.append(f"{name}: rank 0 held {r0['held']}, want {want_held[kind]}")
        if kind == "t5_sp" and set(r0["batch_partition"]) != {
                "inputs", "targets", "input_mask"}:
            failures.append(f"{name}: batch_partition {r0['batch_partition']}")
        if control and min(r0["gap"], r1["gap"]) <= change_tol:
            failures.append(f"{name}: the control stays within {change_tol:g}")
        if not control and (gap > change_tol or loss_gap > loss_tol):
            failures.append(f"{name}: gap {gap:.3e}, loss gap {loss_gap:.3e}")
    for name in ("t5_decode", "t5_decode_control"):
        r0, r1 = two[0][name], two[1][name]
        control = name.endswith("control")
        decode_runs = (T5_DECODE_STEPS + T5_BEAM_STEPS) * T5_DECODE_LAYERS
        must = ", must exceed it" if control else ""
        print(f"t5_moe_two_ranks {name}: {r0['seconds']:.1f} s over gloo (one "
              f"process {one['t5_decode']['seconds']:.1f} s); greedy "
              f"{T5_DECODE_STEPS} tokens x {T5_DECODE_ROWS} prompts into a "
              f"{r0['keys']}-key cache, beam {BEAM} x {T5_BEAM_ROWS}; {r0['heads']} "
              f"heads a rank; greedy: rows parted from one process {r0['parted']} / "
              f"{r1['parted']}, max |logit diff| through the first parting step "
              f"{r0['worst']:.3e} / {r1['worst']:.3e} (tol {DECODE_LOGIT_TOL:g}{must}), "
              f"parity {r0['ok']} / {r1['ok']}; beam: rows parted "
              f"{r0['beam_parted']} / {r1['beam_parted']}, max |log-prob diff| "
              f"through the first parting step {r0['beam_worst']:.3e} / "
              f"{r1['beam_worst']:.3e} (tol {DECODE_LOGIT_TOL:g}{must}), the largest "
              f"near-tie gap at a parting step {r0['tie']:.3e} (tol "
              f"{DECODE_LOGIT_TOL:g}), parity {r0['beam_ok']} / {r1['beam_ok']}; "
              f"ranks' tokens equal {torch.equal(r0['tokens'], r1['tokens'])} / "
              f"{torch.equal(r0['beam'], r1['beam'])}; rank launches "
              f"{r0['launches']} / {r1['launches']}", flush=True)
        if not torch.equal(r0["tokens"], r1["tokens"]) or not torch.equal(
                r0["logits"], r1["logits"]) or not torch.equal(r0["beam"], r1["beam"]):
            failures.append(f"{name}: the two ranks decode apart")
        for kind, ok in (("greedy", "ok"), ("beam", "beam_ok")):
            if control and (r0[ok] or r1[ok]):
                failures.append(f"{name}: the {kind} control stays within "
                                "DECODE_LOGIT_TOL")
            if not control and not (r0[ok] and r1[ok]):
                failures.append(f"{name}: {kind} parity failed (greedy worst "
                                f"{r0['worst']:.3e}, beam worst {r0['beam_worst']:.3e}, "
                                f"near-tie {r0['tie']:.3e})")
        for r, rank in enumerate((r0, r1)):
            want = {**trains, "flash_decode": decode_runs}
            if rank["launches"] != want or rank["heads"] != heads:
                failures.append(f"{name}: rank {r} launched {rank['launches']} on "
                                f"{rank['heads']} heads, want {want} on {heads}")
    launches = {k: [two[r]["moe_tp"]["launches"][k] + two[r]["t5_decode"]["launches"][k]
                    for r in range(2)] for k in trains}
    return launches, failures


# ---- spmd_dag: a BERT-base DAG node by node through run_node (A10)

# The DAG's reviews: candidates made up from the seed, of which the first
# SPMD_SPLIT_ROWS whose content hash sends them to train and as many sent
# to eval make its CSV.  With 64 train rows in two shard files of 32, each
# of the two ranks reads its 32 rows every step and the one process all 64:
# both runs train on the same global batch of DP_BATCH rows, in another
# order, so their losses and changes are comparable.
SPMD_CANDIDATES = 400
SPMD_SPLIT_ROWS = DP_BATCH
SPMD_STEPS = 3
SPMD_EVAL_STEPS = 1
# Run (i)'s planted failure must fail the node on both ranks this fast.
SPMD_FAIL_S = 120.0
# The runner collectives each rank issues in a run of the Trainer node: a
# broadcast of the replayed Cond skip for each of the 4 upstream nodes, the
# inputs' flag and their JSON (a length and the bytes), the cache verdict
# and, when the node executes, the execution id; the status all-gather
# after the executor; run_node's final barrier.
SPMD_EXECUTED_COLLECTIVES = {"broadcast": 9, "allgather": 1, "barrier": 1}
SPMD_CACHED_COLLECTIVES = {"broadcast": 8, "allgather": 0, "barrier": 1}
SPMD_PIPELINE = """\\
import json
import os

from tpu_pipelines_torch.components import (
    CsvExampleGen, SchemaGen, StatisticsGen, Trainer, Transform,
)
from tpu_pipelines_torch.dsl.pipeline import Pipeline


def create_pipeline():
    env = os.environ
    home = env["SPMD_DAG_HOME"]
    gen = CsvExampleGen(input_path=env["SPMD_DAG_CSV"], num_shards=2)
    stats = StatisticsGen(examples=gen.outputs["examples"])
    schema = SchemaGen(statistics=stats.outputs["statistics"])
    transform = Transform(examples=gen.outputs["examples"],
                          schema=schema.outputs["schema"],
                          module_file=env["SPMD_DAG_PREPROCESSING"])
    trainer = Trainer(
        examples=transform.outputs["transformed_examples"],
        transform_graph=transform.outputs["transform_graph"],
        module_file=env["SPMD_DAG_MODULE"],
        train_steps=int(env["SPMD_DAG_STEPS"]),
        eval_steps=int(env["SPMD_DAG_EVAL_STEPS"]),
        hyperparameters=json.loads(env["SPMD_DAG_HPARAMS"]),
        mesh=json.loads(env["SPMD_DAG_MESH"]),
        custom_config={"train_loop": {"checkpoint_every": 0, "log_every": 1}})
    return Pipeline("spmd-bert", [trainer],
                    pipeline_root=os.path.join(home, "root"),
                    metadata_path=os.path.join(home, "metadata.sqlite"))
"""
SPMD_PREPROCESSING = """\\
def preprocessing_fn(inputs, tft):
    ids = tft.tokenize(inputs["text"], max_len={max_len}, vocab_size={vocab})
    return {{"input_ids": ids, "attention_mask": tft.greater(ids, 0),
            "label": tft.cast(inputs["label"], "int32")}}
"""


def spmd_hparams():
    """BERT-base's width at DP_TWO_LAYERS layers, its own vocabulary,
    flash attention, dropout 0, the DP phases' batch and rate."""
    return {"n_layers": DP_TWO_LAYERS, "attn_impl": "flash",
            "vocab_size": TP_VOCAB, "max_len": SEQ_LEN, "num_classes": 2,
            "dropout_rate": 0.0, "batch_size": DP_BATCH,
            "learning_rate": DP_LR}


def spmd_env(home, csv_path, mesh):
    from tpu_pipelines_torch.examples import bert_pipeline

    return {"SPMD_DAG_HOME": home, "SPMD_DAG_CSV": csv_path,
            "SPMD_DAG_PREPROCESSING": os.path.join(home, "preprocessing.py"),
            "SPMD_DAG_MODULE": os.path.join(bert_pipeline.HERE, "bert_module.py"),
            "SPMD_DAG_STEPS": str(SPMD_STEPS),
            "SPMD_DAG_EVAL_STEPS": str(SPMD_EVAL_STEPS),
            "SPMD_DAG_HPARAMS": json.dumps(spmd_hparams()),
            "SPMD_DAG_MESH": json.dumps(mesh)}


def spmd_reviews_csv(path, seed):
    """SPMD_SPLIT_ROWS reviews the hash split sends to train and as many to
    eval, from SPMD_CANDIDATES made-up ones; returns the split counts."""
    from tpu_pipelines_torch.components import example_gen

    lines = [quoted_text(i, text, "she wrote") + f",{label}" for i, (text, label)
             in enumerate(review_rows(seed + 61, SPMD_CANDIDATES))]
    with open(path, "w") as f:
        f.write("\n".join(["text,label"] + lines) + "\n")
    table, kinds = example_gen.read_csv([path])
    masks = example_gen._split_masks(example_gen._row_hash_buckets(
        table, kinds, sum(example_gen.DEFAULT_SPLITS.values())),
        example_gen.DEFAULT_SPLITS)
    keep = sorted(i for split in ("train", "eval")
                  for i in np.flatnonzero(masks[split])[:SPMD_SPLIT_ROWS])
    with open(path, "w") as f:
        f.write("\n".join(["text,label"] + [lines[i] for i in keep]) + "\n")
    return {split: int(min(SPMD_SPLIT_ROWS, masks[split].sum()))
            for split in ("train", "eval")}


@contextlib.contextmanager
def root_logging_kept():
    """``run_node.main`` sets up INFO logging for its process; the root
    logger is put back as it was when the call returns."""
    import logging

    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        yield
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                root.removeHandler(h)
        root.setLevel(level)


@contextlib.contextmanager
def spmd_recording(module_path):
    """The BERT module's train loop and run_fn as the Trainer calls them:
    yields ``seen`` with the initial and trained models' parameters (CPU),
    the logged losses, the TrainResult, the loop's seconds and the
    run_fn's output dirs."""
    from tpu_pipelines_torch.utils.module_loader import load_module

    user = load_module(module_path)
    real_loop, real_run_fn = user.train_loop, user.run_fn
    seen = {"losses": []}

    def loop(**kw):
        real_init = kw["init_params_fn"]

        def init(*args, **kwargs):
            model = real_init(*args, **kwargs)
            seen["init"] = {n: p.detach().cpu().clone()
                            for n, p in model.named_parameters()}
            return model

        def cb(step, metrics):
            seen["losses"] += [float(v) for k, v in metrics.items() if k == "loss"]

        t0 = time.perf_counter()
        model, result = real_loop(**{**kw, "init_params_fn": init,
                                     "metrics_cb": cb})
        seen["loop_s"] = time.perf_counter() - t0
        seen["model"], seen["result"] = model, result
        return model, result

    def run_fn(fn_args):
        seen["model_dir"] = fn_args.serving_model_dir
        seen["eval_uri"] = fn_args.eval_examples_uri
        return real_run_fn(fn_args)

    with mock.patch.object(user, "train_loop", loop), \
            mock.patch.object(user, "run_fn", run_fn):
        yield seen


def param_digests(params):
    import hashlib

    return {n: hashlib.sha256(p.float().numpy().tobytes()).hexdigest()
            for n, p in params.items()}


def store_states(path, node):
    from tpu_pipelines_torch.metadata import open_store

    store = open_store(path)
    try:
        return [ex.state.value for ex in store.get_executions(node_id=node)]
    finally:
        store.close()


def spmd_dag_setup(seed, card, tmp):
    """spmd_dag: the BERT DAG of SPMD_PIPELINE (CsvExampleGen ->
    StatisticsGen -> SchemaGen -> Transform, the native tokenizer's ->
    Trainer, ``examples/bert_module.py``'s run_fn at BERT-base's width on
    ``mesh {"data": 2}``) as a cluster runs it.  ``GPUJobRunner`` emits its
    manifests for one host of two GPUs; each upstream node runs through
    ``run_node.main`` with the argv of its container template, one partial
    run each; the Trainer runs through ``run_node.main`` once in this
    process on a copy of the root and store taken after Transform, at a
    world of one (the baseline), and on the two ranks with the argv and env
    of its JobSet's container (``_spmd_node_job``).  Returns the rank jobs
    and ``finish(two, seconds)`` -> (launches, failures)."""
    from tpu_pipelines_torch import run_node
    from tpu_pipelines_torch.orchestration import GPUJobRunner, GPUJobRunnerConfig
    from tpu_pipelines_torch.orchestration.cluster_runner import k8s_name
    from tpu_pipelines_torch.transform import native_tokenizer
    from tpu_pipelines_torch.utils.module_loader import load_fn

    t_setup = time.perf_counter()
    home = os.path.join(tmp, "spmd_dag")
    os.makedirs(home)
    csv_path = os.path.join(home, "reviews.csv")
    split_rows = spmd_reviews_csv(csv_path, seed)
    if split_rows != {"train": SPMD_SPLIT_ROWS, "eval": SPMD_SPLIT_ROWS}:
        raise AssertionError(f"spmd_dag: split rows {split_rows}")
    with open(os.path.join(home, "preprocessing.py"), "w") as f:
        f.write(SPMD_PREPROCESSING.format(max_len=SEQ_LEN, vocab=TP_VOCAB))
    module = os.path.join(home, "spmd_pipeline.py")
    with open(module, "w") as f:
        f.write(SPMD_PIPELINE)
    env = spmd_env(home, csv_path, {"data": 2})
    with mock.patch.dict(os.environ, env):
        pipeline = load_fn(module, "create_pipeline")()
    out = GPUJobRunner(GPUJobRunnerConfig(
        image="tpu-pipelines-torch:chip-smoke", pipeline_module=module,
        output_dir=os.path.join(home, "manifests"), num_hosts=1,
        gpus_per_host=2)).run(pipeline)
    with open(out["workflow"]) as f:
        workflow = json.load(f)
    with open(out["jobset_Trainer"]) as f:
        jobset = json.load(f)
    templates = {t["name"]: t for t in workflow["spec"]["templates"]}
    if "resource" not in templates["trainer"] or sorted(out) != [
            "jobset_Trainer", "pipeline_ir", "workflow"]:
        raise AssertionError(f"spmd_dag: manifests {sorted(out)}")

    native_tokenizer.reset_counters()
    walls = {}
    for node in ("CsvExampleGen", "StatisticsGen", "SchemaGen", "Transform"):
        cmd = templates[k8s_name(node)]["container"]["command"]
        if cmd[:3] != ["python", "-m", "tpu_pipelines_torch.run_node"]:
            raise AssertionError(f"spmd_dag: {node}'s command {cmd}")
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, env), root_logging_kept():
            code = run_node.main(cmd[3:])
        walls[node] = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"spmd_dag: {node} exited {code}")
    tokenized = native_tokenizer.counters()
    if (tokenized["native_rows"] != 2 * SPMD_SPLIT_ROWS
            or tokenized["python_rows"] or tokenized["count_python_rows"]):
        raise AssertionError(f"spmd_dag: Transform's tokenizer {tokenized}")

    # The Trainer's pod: torchrun over run_node, the argv after its module.
    container = jobset["spec"]["replicatedJobs"][0]["template"]["spec"][
        "template"]["spec"]["containers"][0]
    cmd = container["command"]
    at = cmd.index("-m")
    launcher = dict(zip(cmd[1:at:2], cmd[2:at:2]))
    if (cmd[0] != "torchrun" or cmd[at + 1] != "tpu_pipelines_torch.run_node"
            or launcher["--nnodes"] != "1" or launcher["--nproc-per-node"] != "2"):
        raise AssertionError(f"spmd_dag: the Trainer pod's command {cmd}")
    argv = cmd[at + 2:]
    # The pod's env as the Job controller fills it (the completion index)
    # and torchrun's per process (filled in each rank's job).
    pod_env = {e["name"]: e.get("value", "0") for e in container["env"]}

    # The baseline: a copy of the root and store after Transform, the
    # Trainer at a world of one on the same global batch.
    one_home = os.path.join(tmp, "spmd_dag_one")
    shutil.copytree(home, one_home)
    one_env = spmd_env(one_home, csv_path, {"data": 1})
    zero_counters()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, one_env), root_logging_kept(), \
            spmd_recording(env["SPMD_DAG_MODULE"]) as one:
        code = run_node.main(argv)
    one_s = time.perf_counter() - t0
    one_launches = by_record(counters())
    if code != 0:
        raise AssertionError(f"spmd_dag: the one-process Trainer exited {code}")
    # Read by finish, after two_rank_jobs has removed ``tmp``.
    keep = tempfile.mkdtemp()
    paths = {"one_init": os.path.join(keep, "one_init.pt"),
             "one_final": os.path.join(keep, "one_final.pt"),
             "two_final": os.path.join(keep, "two_final.pt")}
    torch.save(one["init"], paths["one_init"])
    torch.save({n: p.detach().cpu() for n, p in one["model"].named_parameters()},
               paths["one_final"])
    baseline = {"losses": one["losses"], "loop_s": one["loop_s"],
                "steps": one["result"].steps_completed,
                "eps": one["result"].examples_per_sec, "seconds": one_s,
                "launches": one_launches, "walls": walls,
                "setup_s": time.perf_counter() - t_setup}
    del one
    jobs = [("spmd_node", "spmd_node", {
        "argv": argv, "env": {**env, **pod_env}, "home": home,
        "out_path": paths["two_final"]})]
    return jobs, functools.partial(_spmd_dag_finish, card, baseline, keep, paths)


def _spmd_node_job(seed, *, argv, env, home, out_path):
    """One rank of the Trainer's pod: ``run_node.main(argv)`` three times
    with the env torchrun gives rank r of a world of two: (i) a failure
    planted in rank 1's executor attempt, after its collectives
    (``faults.RAISE_AFTER``); (ii) the node again, as the substrate's retry
    would run it; (iii) a third time.  Each run's exit code, wall,
    launches, runner collectives and the output dirs; for (ii) the losses,
    the trained and initial parameters' digests (rank 0 saves the trained
    ones to ``out_path``), and on rank 0 the payload's logits against the
    trained model's and the store's executions."""
    import torch.distributed as dist

    from tpu_pipelines_torch import run_node
    from tpu_pipelines_torch.parallel import distributed
    from tpu_pipelines_torch.testing import faults

    rank = dist.get_rank()
    rank_env = {**env, "RANK": str(rank), "LOCAL_RANK": str(rank),
                "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2", "GROUP_RANK": "0",
                "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}
    out = {}
    for tag in ("fail", "retry", "cached"):
        zero_counters()
        distributed.reset_collectives_issued()
        plan = (faults.FaultPlan({"Trainer": faults.NodeFault(faults.RAISE_AFTER)})
                if tag == "fail" and rank == 1 else None)
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, rank_env), root_logging_kept(), \
                spmd_recording(env["SPMD_DAG_MODULE"]) as seen, \
                (plan.activate() if plan else contextlib.nullcontext()):
            code = run_node.main(argv)
        run = {"code": code, "wall_s": time.perf_counter() - t0,
               "launches": by_record(counters()),
               "issued": distributed.collectives_issued(),
               "model_dir": seen.get("model_dir")}
        if tag == "retry":
            params = {n: p.detach().cpu() for n, p in seen["model"].named_parameters()}
            run.update(losses=seen["losses"], loop_s=seen["loop_s"],
                       steps=seen["result"].steps_completed,
                       eps=seen["result"].examples_per_sec,
                       digests=param_digests(params),
                       init_digests=param_digests(seen["init"]))
            if rank == 0:
                torch.save(params, out_path)
                run["payload_gap"] = _spmd_payload_gap(seen)
            run["files"] = sorted(os.listdir(seen["model_dir"]))
        if rank == 0:
            run["executions"] = store_states(
                os.path.join(home, "metadata.sqlite"), "Trainer")
        out[tag] = run
        dist.barrier()
    return out


def _spmd_payload_gap(seen, rows=8):
    """The exported payload, loaded on the card, against the trained
    model's logits on ``rows`` transformed eval rows: the max |diff|."""
    from tpu_pipelines_torch.data import examples_io

    data = examples_io.read_split(seen["eval_uri"], "eval")
    batch = {k: np.asarray(v[:rows]) for k, v in data.items() if k != "label"}
    model = seen["model"].eval()
    with torch.no_grad():
        want = model({k: torch.as_tensor(v, device=DEVICE)
                      for k, v in batch.items()}).float().cpu()
    loaded = load_exported_model(seen["model_dir"], device=DEVICE)
    got = torch.as_tensor(loaded.predict_transformed(batch)).float().cpu()
    return float((got - want).abs().max())


def _spmd_dag_finish(card, one, keep, paths, two, two_s):
    """spmd_dag's checks on the two ranks' runs: (i) failed on both within
    SPMD_FAIL_S, one FAILED execution and no cache entry; (ii) executed,
    one COMPLETE execution, one output dir with the payload, each rank's
    training launches DP_TWO_LAYERS x SPMD_STEPS of every attention kernel,
    the ranks one model bit for bit, losses within DP_LOSS_TOL and the
    parameter changes within DP_CHANGE_TOL of the one process, the payload's
    logits the trained model's; (iii) CACHED on both with no launch."""
    try:
        return _spmd_dag_checks(card, one, paths, two, two_s)
    finally:
        shutil.rmtree(keep, ignore_errors=True)


def _spmd_dag_checks(card, one, paths, two, two_s):
    failures = []
    r0, r1 = (two[r]["spmd_node"] for r in range(2))
    fail, retry, cached = ([r[t] for r in (r0, r1)]
                           for t in ("fail", "retry", "cached"))
    train = DP_TWO_LAYERS * SPMD_STEPS
    if [r["code"] for r in fail] != [1, 1] or max(
            r["wall_s"] for r in fail) > SPMD_FAIL_S:
        failures.append(f"(i) exit codes {[r['code'] for r in fail]} in "
                        f"{[round(r['wall_s'], 1) for r in fail]} s")
    if r0["fail"]["executions"] != ["FAILED"]:
        failures.append(f"(i) the store holds {r0['fail']['executions']}")
    if [r["code"] for r in retry] != [0, 0] or r0["retry"]["executions"] != [
            "FAILED", "COMPLETE"]:
        failures.append(f"(ii) exit codes {[r['code'] for r in retry]}, the "
                        f"store holds {r0['retry']['executions']} (a cache "
                        "entry from (i) would make it CACHED)")
    if retry[0]["model_dir"] != retry[1]["model_dir"] or not {
            "model_spec.json"} <= set(retry[0]["files"]):
        failures.append(f"(ii) output dirs {retry[0]['model_dir']} / "
                        f"{retry[1]['model_dir']}, files {retry[0]['files']}")
    evals = []
    for r, run in enumerate(retry):
        got = run["launches"]
        evals.append(got["flash_fwd"] - train)
        if (got["flash_bwd_dq"], got["flash_bwd_dkv"], got["flash_bwd_dvec"]) != (
                train, train, train) or evals[-1] < 0 or got["flash_decode"]:
            failures.append(f"(ii) rank {r} launched {got}, want {train} of "
                            "each training kernel")
    if retry[0]["digests"] != retry[1]["digests"]:
        apart = sum(retry[0]["digests"][n] != retry[1]["digests"][n]
                    for n in retry[0]["digests"])
        failures.append(f"(ii) the ranks hold {apart} parameters apart")
    one_init = torch.load(paths["one_init"])
    if retry[0]["init_digests"] != param_digests(one_init):
        failures.append("(ii) the ranks started from another model than the "
                        "one process")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(retry[0]["losses"],
                                                        one["losses"]))
    change_gap = param_change_gap(torch.load(paths["two_final"]),
                                  torch.load(paths["one_final"]), one_init)
    if (len(retry[0]["losses"]) != SPMD_STEPS or retry[0]["losses"] != retry[1][
            "losses"] or loss_gap > DP_LOSS_TOL or change_gap > DP_CHANGE_TOL):
        failures.append(f"(ii) losses {retry[0]['losses']} / {retry[1]['losses']} "
                        f"against {one['losses']}: gap {loss_gap:.3e}, changes "
                        f"{change_gap:.3e}")
    if retry[0]["payload_gap"] > LOGIT_TOL:
        failures.append(f"(ii) payload logits {retry[0]['payload_gap']:.3e} off")
    if [r["code"] for r in cached] != [0, 0] or r0["cached"]["executions"] != [
            "FAILED", "COMPLETE", "CACHED"] or any(
                any(r["launches"].values()) for r in cached):
        failures.append(f"(iii) exit codes {[r['code'] for r in cached]}, the "
                        f"store {r0['cached']['executions']}, launches "
                        f"{[r['launches'] for r in cached]}")
    for tag, runs, want in (("(i)", fail, SPMD_EXECUTED_COLLECTIVES),
                            ("(ii)", retry, SPMD_EXECUTED_COLLECTIVES),
                            ("(iii)", cached, SPMD_CACHED_COLLECTIVES)):
        if [r["issued"] for r in runs] != [want, want]:
            failures.append(f"{tag} runner collectives "
                            f"{[r['issued'] for r in runs]}, want {want} a rank")
    one_step = 1e3 * DP_BATCH / max(one["eps"], 1e-9)
    two_step = 1e3 * DP_BATCH / max(retry[0]["eps"], 1e-9)
    print(f"spmd_dag [{card}]: BERT-base width, {DP_TWO_LAYERS} layers, "
          f"vocabulary {TP_VOCAB}, {SPMD_STEPS} steps at {DP_BATCH} x {SEQ_LEN}; "
          "upstream nodes through run_node.main: " + ", ".join(
              f"{k} {v:.2f} s" for k, v in one["walls"].items())
          + f"; one process (world 1) {one['seconds']:.1f} s, losses "
          + " ".join(f"{x:.6f}" for x in one["losses"])
          + f", launches {one['launches']}; setup {one['setup_s']:.1f} s",
          flush=True)
    print(f"spmd_dag runs [{card}]: (i) failure planted in rank 1 after its "
          f"collectives: exit {[r['code'] for r in fail]} in "
          f"{[round(r['wall_s'], 1) for r in fail]} s, store "
          f"{r0['fail']['executions']}; (ii) exit {[r['code'] for r in retry]} "
          f"in {[round(r['wall_s'], 1) for r in retry]} s, store "
          f"{r0['retry']['executions']}, one model dir {retry[0]['model_dir']}, "
          f"launches {[r['launches'] for r in retry]} ({train} training a kernel, "
          f"eval forwards {evals}), losses " + " ".join(
              f"{x:.6f}" for x in retry[0]["losses"])
          + f", loss gap {loss_gap:.3e} (tol {DP_LOSS_TOL:g}), change gap "
          f"{change_gap:.3e} (tol {DP_CHANGE_TOL:g}), ranks one model bit for "
          f"bit {retry[0]['digests'] == retry[1]['digests']}, payload logits "
          f"{retry[0]['payload_gap']:.3e} (tol {LOGIT_TOL:g}); step "
          f"{two_step:.1f} ms on two ranks against {one_step:.1f} ms in one "
          f"process; (iii) exit {[r['code'] for r in cached]} in "
          f"{[round(r['wall_s'], 1) for r in cached]} s, store "
          f"{r0['cached']['executions']}, launches 0; runner collectives a "
          f"run and rank: {[r['issued'] for r in fail + retry + cached]}; "
          f"spawn {two_s:.1f} s", flush=True)
    launches = {name: [run["launches"][name] for run in retry]
                for name in retry[0]["launches"]}
    return launches, failures


# ---- native_cores: the record and tokenizer cores (A24)

# ImportExampleGen's seconds for the ResNet DAG's RESNET_DAG_ROWS rows
# before the host cores (NVIDIA H100 80GB HBM3, 700.00 W), printed beside
# this run's.
RESNET_INGEST_BEFORE_S = 41.71
CRC_BYTES = 1 << 20
# native_cores' parse: PARSE_CHUNKS chunks of PARSE_CHUNK_ROWS records.
PARSE_CHUNK_ROWS, PARSE_CHUNKS = 2048, 3


def native_cores_phase(seed, card):
    """Build both host cores (one g++ each, started together), hold the C
    crc32c against the table version on CRC_BYTES seeded bytes and on the
    check value crc32c(b"123456789") = 0xE3069283, and time both; then
    parse PARSE_CHUNKS seeded record chunks through ``tf_example_batches``
    (the first in Python, the rest by the core) against the Python parse of
    every chunk, column for column."""
    from tpu_pipelines_torch.data import native_record, record_io
    from tpu_pipelines_torch.transform import native_tokenizer

    seconds, errors = {}, {}

    def build(name, core):
        try:
            seconds[name] = core.build_seconds()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors[name] = e

    threads = [threading.Thread(target=build, args=args) for args in (
        ("record_core", native_record), ("tokenizer_core", native_tokenizer))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"host core build failed: {errors}")
    wall = time.perf_counter() - t0
    data = np.random.default_rng(seed + 67).integers(
        0, 256, CRC_BYTES, dtype=np.uint8).tobytes()
    native_record.crc32c(data)  # loads the library
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        got = native_record.crc32c(data)
    c_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    want = record_io._crc32c_py(data)
    table_s = time.perf_counter() - t0
    check = native_record.crc32c(b"123456789")
    if got != want or check != 0xE3069283:
        raise AssertionError(f"native_cores: crc32c {got:#x} against the table "
                             f"version's {want:#x}, check value {check:#x}")
    out = {"build_s": seconds, "crc_MBps": CRC_BYTES / c_s / 1e6,
           "table_MBps": CRC_BYTES / table_s / 1e6}
    out.update(_native_parse_check(seed))
    print(f"native_cores [{card}]: g++ record_core {seconds['record_core']:.1f} s, "
          f"tokenizer_core {seconds['tokenizer_core']:.1f} s (0.0: already "
          f"built), wall {wall:.1f} s; crc32c of {CRC_BYTES} seeded bytes "
          f"{got:#010x} == the table version's, crc32c(b'123456789') = "
          f"{check:#x}; C {out['crc_MBps']:.1f} MB/s (mean of {reps}), table "
          f"version {out['table_MBps']:.2f} MB/s; {PARSE_CHUNKS} chunks of "
          f"{PARSE_CHUNK_ROWS} records == the Python parse's, {out['native_chunks']} "
          f"by the core ({out['native_records']} records, 0 refused): "
          f"{out['parse_s']:.3f} s against {out['python_parse_s']:.3f} s all in "
          "Python", flush=True)
    return out


def _native_parse_check(seed):
    """PARSE_CHUNKS chunks of seeded records through ``tf_example_batches``
    and through the Python parse alone; raises unless every column is
    equal and every chunk after the first went through the core."""
    from tpu_pipelines_torch.data import native_record, record_io

    rng = np.random.default_rng(seed + 68)
    n = PARSE_CHUNK_ROWS * PARSE_CHUNKS
    recs = [encode_example({
        "name": [f"row-{i}".encode()],
        "fare": np.asarray([rng.normal()], np.float32),
        "count": np.asarray([int(rng.integers(-10**12, 10**12))]),
        "vec": rng.normal(size=3).astype(np.float32)}) for i in range(n)]
    native_record.reset_counters()
    t0 = time.perf_counter()
    got = list(record_io.tf_example_batches(iter(recs),
                                            batch_rows=PARSE_CHUNK_ROWS))
    parse_s = time.perf_counter() - t0
    seen = native_record.counters()
    pins, order = {}, []
    t0 = time.perf_counter()
    want = [record_io._chunk(recs[i:i + PARSE_CHUNK_ROWS], pins, order)
            for i in range(0, n, PARSE_CHUNK_ROWS)]
    python_s = time.perf_counter() - t0
    equal = len(got) == len(want) and all(
        list(a.columns) == list(b.columns) and all(
            a.columns[k].dtype == b.columns[k].dtype
            and np.array_equal(a.columns[k], b.columns[k]) for k in b.columns)
        for a, b in zip(got, want))
    if not equal or seen["native_chunks"] != PARSE_CHUNKS - 1 or seen[
            "python_chunks"] or seen["pin_chunks"] != 1:
        raise AssertionError(f"native_cores: the parse through the core equal "
                             f"to the Python parse: {equal}, counters {seen}")
    return {"parse_s": parse_s, "python_parse_s": python_s,
            "native_chunks": seen["native_chunks"],
            "native_records": seen["native_records"]}


@contextlib.contextmanager
def host_cores_counted():
    """The record and tokenizer cores' counters from 0 and every call of
    the table crc counted; yields a dict filled with all of them on exit."""
    from tpu_pipelines_torch.data import native_record, record_io
    from tpu_pipelines_torch.transform import native_tokenizer

    native_record.reset_counters()
    native_tokenizer.reset_counters()
    seen = {"table_crc_calls": 0}
    real = record_io._crc32c_py

    def counted(data):
        seen["table_crc_calls"] += 1
        return real(data)

    with mock.patch.object(record_io, "_crc32c_py", counted):
        yield seen
    seen.update(native_record.counters())
    seen.update(native_tokenizer.counters())


def check_host_cores(name, seen, card, records=False, rows=0):
    """Every crc through C (the table version never called), no record
    chunk refused by the record core (``records``: at least one record
    read), and ``rows`` or more rows encoded by the tokenizer core with
    none by the Python engine.  A stream's first chunk is parsed in Python
    (it pins the schema), so a record file of one chunk never reaches the
    core's parse; native_cores holds the parse on a longer stream."""
    read = seen["native_records"] + seen["pin_records"]
    bad = seen["table_crc_calls"] or seen["python_chunks"] or (
        seen["crc_calls"] < 2 * read) or seen["python_rows"] \
        or seen["count_python_rows"] or seen["native_rows"] < rows or (
            records and not read)
    print(f"{name} host cores [{card}]: records parsed natively "
          f"{seen['native_records']} in {seen['native_chunks']} chunks, in "
          f"Python to pin the schema {seen['pin_records']} in "
          f"{seen['pin_chunks']} chunks, chunks refused by the core and "
          f"re-parsed in Python {seen['python_chunks']}, C crc {seen['crc_calls']} "
          f"calls over {seen['crc_nbytes']} bytes, table crc calls "
          f"{seen['table_crc_calls']}; rows encoded natively "
          f"{seen['native_rows']}, by the Python engine {seen['python_rows']}; "
          f"rows counted natively {seen['count_native_rows']}, in Python "
          f"{seen['count_python_rows']}", flush=True)
    if bad:
        raise AssertionError(f"{name}: a path left the host cores: {seen}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=128)
    parser.add_argument("--train-steps", type=int, default=12)
    parser.add_argument("--generate-requests", type=int, default=8)
    parser.add_argument("--table-out", default="",
                        help="also write the crossovers measured in this run "
                             "as an autotune table here (the format of "
                             "tpu_pipelines_torch/ops/autotune_table.json)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA GPU only", file=sys.stderr)
        return 2

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = [time.perf_counter()]
    started = clock[0]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    build_kernels()
    phase_done("build")
    native_cores_phase(args.seed, card)
    phase_done("native_cores")
    gen = torch.Generator().manual_seed(args.seed)
    fwd = kernel_phase(gen)
    bwd = bwd_kernel_phase(gen)
    decode = decode_kernel_phase(gen)
    phase_done("kernels")
    # The crossovers "auto" reads, measured here before any phase runs
    # "auto", into a cache of this run's own (nothing recorded earlier on
    # the machine is read).
    cache = tempfile.TemporaryDirectory()
    os.environ["TPP_AUTOTUNE_CACHE"] = cache.name
    measured = crossover_phase(gen, card)
    if args.table_out:
        with open(args.table_out, "w") as f:
            json.dump({"version": 1, "entries": {}, **measured}, f,
                      indent=1, sort_keys=True)
            f.write("\n")
    phase_done("crossover")

    with tempfile.TemporaryDirectory() as workdir:
        served = serving_phase(args.seed, args.requests, card, workdir)
        phase_done("serving")
        generated, t5_payload = generate_phase(args.seed, args.generate_requests,
                                               card, workdir)
        phase_done("generate")
        fleet = fleet_phase(args.seed, args.requests, args.generate_requests,
                            card, workdir)
        phase_done("fleet")
    engine = engine_phase(t5_payload, args.seed, card)
    phase_done("engine")
    engine_long = engine_long_phase(t5_payload, args.seed, card)
    phase_done("engine_long")
    # The serving_surface phase serves the T5 payload this phase exports.
    surface = tempfile.TemporaryDirectory()
    levers, levers_by_program = engine_levers_phase(t5_payload, args.seed, card,
                                                    surface.name)
    del t5_payload
    phase_done("engine_levers")
    trained = training_phase(args.seed, args.train_steps, card)
    phase_done("training")
    moe_trained, moe_state = moe_train_phase(args.seed, args.train_steps, card)
    phase_done("moe_train")
    with tempfile.TemporaryDirectory() as workdir:
        moe_served = moe_serving_phase(args.seed, card, workdir, moe_state)
    del moe_state
    phase_done("moe_serving")
    dp_trained = dp_train_phase(args.seed, card)
    phase_done("dp_train")
    # seq_expert_two_ranks, tp_pp_two_ranks, t5_moe_two_ranks and
    # spmd_dag: their one-process runs, then every rank job of all four in
    # one spawn of two gloo ranks.
    ((sp_launches, sp_failures), (tp_pp_launches, tp_pp_failures),
     (t5_moe_launches, t5_moe_failures),
     (spmd_launches, spmd_failures)) = two_rank_jobs(
        args.seed, card,
        [seq_expert_setup, tp_pp_setup, t5_moe_setup, spmd_dag_setup])
    if sp_failures:
        raise AssertionError("seq_expert_two_ranks: " + "; ".join(sp_failures))
    if tp_pp_failures:
        raise AssertionError("tp_pp_two_ranks: " + "; ".join(tp_pp_failures))
    if t5_moe_failures:
        raise AssertionError("t5_moe_two_ranks: " + "; ".join(t5_moe_failures))
    if spmd_failures:
        raise AssertionError("spmd_dag: " + "; ".join(spmd_failures))
    phase_done("seq_expert_two_ranks + tp_pp_two_ranks + t5_moe_two_ranks "
               "+ spmd_dag")
    with tempfile.TemporaryDirectory() as workdir:
        staged_dag_phase(card, workdir)
    phase_done("staged_dag")
    # The taxi DAG launches none of the attention kernels (its Transform
    # and model are plain torch): the counters stay where training left
    # them, and the phase checks so.
    before = counters()
    with tempfile.TemporaryDirectory() as workdir:
        taxi_dag_phase(args.seed, card, workdir)
    if counters() != before:
        raise AssertionError("taxi_dag: an attention kernel launched")
    phase_done("taxi_dag")
    with tempfile.TemporaryDirectory() as workdir:
        with host_cores_counted() as cores:
            bert_dag, production = bert_dag_phase(args.seed, card, workdir)
        check_host_cores("bert_dag", cores, card, rows=BERT_DAG_ROWS)
        phase_done("bert_dag")
        with host_cores_counted() as cores:
            retrain, pushed = retrain_dag_phase(args.seed, card, workdir,
                                                production)
        check_host_cores("retrain_dag", cores, card, records=True)
        phase_done("retrain_dag")
        guard = fleet_guard_phase(args.seed, card, workdir, production, pushed)
        phase_done("fleet_guard")
        continuous = continuous_phase(args.seed, card, workdir, production)
        phase_done("continuous")
        machinery = dag_machinery_phase(args.seed, card, workdir)
        phase_done("dag_machinery")
        surface_fwd, surface_decode = serving_surface_phase(
            args.seed, card, workdir, production, surface.name)
        surface.cleanup()
        phase_done("serving_surface")
    with tempfile.TemporaryDirectory() as workdir:
        tuned = tune_rewrite_phase(args.seed, card, workdir)
    phase_done("tune_rewrite")
    with tempfile.TemporaryDirectory() as workdir:
        t5_dag = t5_dag_phase(args.seed, card, workdir)
    phase_done("t5_dag")
    # The vision workloads launch none of the attention kernels: the
    # counters stay where t5_dag left them (each DAG phase also reads its
    # own run's, zeroed just before it).
    before = counters()
    with tempfile.TemporaryDirectory() as workdir:
        payload = vision_train_phase(args.seed, args.train_steps, card, workdir)
        phase_done("vision_train")
        vision_serving_phase(args.seed, card, workdir, payload)
        phase_done("vision_serving")
    if counters() != before:
        raise AssertionError("vision phases: an attention kernel launched")
    for name in ("mnist", "resnet"):
        with tempfile.TemporaryDirectory() as workdir:
            walls = vision_dag_phase(name, args.seed, card, workdir)
        if name == "resnet":
            # The twin imports an .npz (no TFRecord, so no crc): its ingest
            # is the npz hash split's.
            print(f"resnet_dag ImportExampleGen [{card}]: "
                  f"{walls['ImportExampleGen']:.2f} s for {RESNET_DAG_ROWS} rows "
                  f"({RESNET_DAG_ROWS / walls['ImportExampleGen']:.1f} rows/s); "
                  f"{RESNET_INGEST_BEFORE_S} s before the host cores "
                  "(NVIDIA H100 80GB HBM3, 700.00 W)", flush=True)
        phase_done(f"{name}_dag")
    cache.cleanup()
    print(f"chip_smoke: every phase passed in {time.perf_counter() - started:.1f} s",
          flush=True)
    # launches: each kernel's count in its own paths' runs: training for the
    # four flash-attention kernels (Dvec's count on the dq record), :generate
    # plus both engine runs for flash_decode; launches_by_path adds the
    # serving path's flash_fwd count and each kernel's count in the pipeline
    # DAGs and the continuous controller's ticks, each read from inside the
    # runner.
    fwd["launches_by_path"] = {"serving": served, "fleet": fleet["flash_fwd"],
                               "training": trained["flash_fwd"]}
    decode["launches_by_path"] = {"serving": generated, "engine": engine,
                                  "engine_long": engine_long,
                                  "fleet": fleet["flash_decode"],
                                  "engine_levers": levers,
                                  "serving_surface": surface_decode}
    # The lever runs' launches by program: the target's and the draft
    # lane's step replays, the verify windows (dense: none) and prefills.
    decode["engine_levers_by_program"] = levers_by_program
    for record in bwd:
        record["launches_by_path"] = {"training": trained[record["name"]]}
    bwd[0]["dvec_launches_by_path"] = {"training": trained["flash_bwd_dvec"],
                                       "dp_train": dp_trained["flash_bwd_dvec"]}
    for record in (fwd, *bwd):
        record["launches_by_path"]["dp_train"] = dp_trained[record["name"]]
        record["launches_by_path"]["moe_train"] = moe_trained[record["name"]]
        record["launches_by_path"]["seq_expert_two_ranks"] = sp_launches[
            record["name"]]
        record["launches_by_path"]["tp_pp_two_ranks"] = {
            kind: [rank[record["name"]] for rank in ranks]
            for kind, ranks in tp_pp_launches.items()}
    bwd[0]["dvec_launches_by_path"]["moe_train"] = moe_trained["flash_bwd_dvec"]
    bwd[0]["dvec_launches_by_path"]["seq_expert_two_ranks"] = sp_launches[
        "flash_bwd_dvec"]
    bwd[0]["dvec_launches_by_path"]["tp_pp_two_ranks"] = {
        kind: [rank["flash_bwd_dvec"] for rank in ranks]
        for kind, ranks in tp_pp_launches.items()}
    # t5_moe_two_ranks: each rank's own, the MoE job's training kernels
    # and the decoding job's flash_decode.
    for record in (fwd, *bwd, decode):
        record["launches_by_path"]["t5_moe_two_ranks"] = t5_moe_launches[
            record["name"]]
    bwd[0]["dvec_launches_by_path"]["t5_moe_two_ranks"] = t5_moe_launches[
        "flash_bwd_dvec"]
    # spmd_dag: each rank's launches in run (ii), the Trainer node under
    # spmd_sync (its eval forwards on the forward's count).
    for record in (fwd, *bwd, decode):
        record["launches_by_path"]["spmd_dag"] = spmd_launches[record["name"]]
    bwd[0]["dvec_launches_by_path"]["spmd_dag"] = spmd_launches["flash_bwd_dvec"]
    fwd["launches_by_path"]["moe_serving"] = moe_served
    fwd["launches_by_path"]["fleet_guard"] = guard
    fwd["launches_by_path"]["serving_surface"] = surface_fwd
    for path, counts in (("bert_dag", bert_dag), ("retrain_dag", retrain),
                         ("continuous", continuous),
                         ("dag_machinery", machinery), ("t5_dag", t5_dag),
                         ("tune_rewrite", tuned)):
        for record in (fwd, *bwd, decode):
            record["launches_by_path"][path] = counts[record["name"]]
        bwd[0]["dvec_launches_by_path"][path] = counts["flash_bwd_dvec"]
    trained["flash_decode"] = (generated + engine + engine_long
                               + fleet["flash_decode"] + levers + surface_decode)
    records = [fwd, *bwd, decode]
    bwd[0]["dvec_launches"] = trained["flash_bwd_dvec"]
    for record in records:
        record["launches"] = trained[record["name"]]
        record["max_err"] = record["max_abs_err"]
        record["card"] = card
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
