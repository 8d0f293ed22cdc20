#!/usr/bin/env python3
"""Drive the PyTorch port (distributed_tf_serving_tpu_torch) on one NVIDIA
card, end to end, and fail loudly on anything wrong.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device  — card name; `nvidia-smi` name and power limit.
2. build   — nvcc builds every kernel source of the package (sm_90a) while
             g++ builds the native host ops (native/hostops.cc).
3. kernels — each kernel at the serving width (43 fields x 16, vocab 2^20,
             3 cross layers, MLP 256/128/64), in bf16 and in f32 at the four
             buckets of configs/latency.toml (256, 512, 1024, 2048), held
             against its plain PyTorch version on the same inputs, and
             timed beside it three ways: `ms`, CUDA
             events around one call (the wrapper's host time included, as
             the serving path pays it); `loop_ms`, around runs of 50
             back-to-back calls; `device_ms`, the device time of one call
             from torch.profiler. The fused
             serve step runs on the seed-0 demo weights (fused_serve) and
             on their ops/quantize.py int8 tree (fused_serve_int8), at the
             cluster size its rule picks (`cluster`), and again with every
             cluster size 1, 2, 4, 8 forced, each forced run held to the
             plain version and model.apply and timed (`loop_ms`,
             `device_ms`); in both dtypes each forced run must give the
             bits of C = 1. The cross stack runs at the (rows per block, cluster)
             plan its rule picks (`rows_per_block`, `cluster`) and again at
             every forced plan in {16, 32} x {1, 2, 4, 8}, each forced run
             bit-identical to (16, 1) and held to the plain version, and
             timed (`loop_ms`, `device_ms`); 20 warm calls of each cross stack
             must launch the cross kernel alone (its weight operands are
             cached). The cards' cluster capacities
             (cudaOccupancyMaxActiveClusters of each kernel at its shared
             memory) and nvcc's registers per kernel and spills are
             printed, and every rule row carries its kernel's `registers`
             and `spill_bytes`; a spill, or a kernel over 128 registers,
             fails. The f32 bound counts the operations at the split-TF32
             rate (3 mmas per product, 2 for int8 weights, at 494.7
             TFLOP/s), below which no tensor-core f32 kernel can go.
             In f32 each rule row is also held to a float64 truth on
             unit-normal inputs (x0 for the cross stack, the embedding
             table for the fused serve step), where an f32 sum is itself
             far from the truth: the kernel's max error must be at most 2x
             the plain f32 version's, and the plain version with TF32
             matmuls must miss that rule (`unit_normal_*` keys).
             Tolerances: fused serve scores 2e-5 (f32) / 5e-3 (bf16), and
             5e-3 against model.apply (bf16 for float weights, both dtypes
             on the int8 tree); cross stack allclose with rtol = atol =
             1e-5 (f32) / 2e-2 (bf16). The int8 kernel's |dscore| against
             the float model.apply is recorded, not gated (the autotune's
             max_abs_delta gate reads it).
4. serving — the gRPC server (configs/latency.toml buckets, full-width
             dcn_v2 demo servable on cuda) answers Predicts of 7, 1000 and
             2048 candidates over a 127.0.0.1 socket (through
             DynamicBatcher.submit when grpc/protobuf are missing); scores
             are held to the plain forward (model.apply) at 5e-3. A second
             server runs the `use_pallas_cross` configuration, whose
             model.apply routes the cross stack through its kernel. A third,
             `kernels_plane`, arms [kernels] (int8 quantization and the fused
             kernel, JAX-default gates): its per-bucket autotune table is
             printed, a fused variant that errored fails the run, and its
             scores are held to model.apply on the tree each bucket's
             decision picked; the same payloads then go through its
             pallas_int8 entry (`_execute` with `_kernel_override=(True,
             True)`), held to model.apply on the int8 tree. Three more,
             `fused_serve_f32`, `cross_stack_f32` and `kernels_plane_f32`,
             are the same in f32 (the AUC-parity mode), held to the plain
             f32 forward at 2e-5. The kernels' launch counters, one per
             kernel and compute dtype, are zeroed just before the requests
             and must all have moved by the end, the f32 fused serve and
             cross-stack kernels' once per request of their f32 server; the
             cross_stack servers must not prepare their cross weights again
             during their requests.
5. host    — the serving host path (serving/batcher.py). Over each server's
             counted requests every batch must be one combined buffer and
             one H2D copy or a hit of the device input cache (copies + hits
             = batches), every other bf16 batch packed by the native
             pack_batch_u24_bf16, and the readback must overlap (a
             completion worker waits for it). Then, on every server, the
             combined path's scores must have the bits of the per-key
             path's. On the bf16 fused_serve server: the stage breakdown at
             buckets 256, 512, 1024 and 2048 (fused_pack, h2d_unpack, device_step,
             d2h_issue, d2h_wait, beside the per-key path's perkey_fold_pack,
             perkey_h2d_unpack, perkey_d2h), the n = 7 submit p50 split into
             submit, collect, staged, dispatch_stage, readback_wait and
             completion_handoff (again with no coalescing window), the gRPC floor and busy share, and a closed
             loop of 4 client threads x 250 gRPC Predicts of n = 1000 (the
             [client] point of configs/latency.toml) at pipeline_depth 1 and
             2: p50, p99, QPS and the card's busy share.

6. lifecycle — the model lifecycle (train/checkpoint.py,
             serving/version_watcher.py, serving/warmup.py): v1 (seed 0)
             written with save_servable at the full width of
             configs/latency.toml into a temporary base path, with an
             assets.extra/tf_serving_warmup_requests file of Predict records
             at n = 7, 1000 and 2048; the CLI server started on it with
             --model-base-path and a 0.25 s poll; 4 client threads of
             unpinned gRPC Predicts (n = 1000) while v2 (seed 1) and then v3
             (seed 2) are written, manifest last. No request may fail, every
             response must be within 5e-3 of the plain forward of the version
             its model_spec names, GetModelStatus must end at [2, 3], and the
             server must log 3 replayed records per version. Printed per
             version: the safetensors read, the H2D copy, the bucket warmup,
             the replay, manifest -> flip and manifest -> first response;
             the closed loop's p50/p99 before, across and after each swap;
             the fused_serve launches of each version's period (from the
             server's log of its launch counters at each version change and
             at shutdown). Then a --checkpoint server on v3 must answer
             within 5e-3 of v3's plain forward, and in this process v1 is
             loaded and retired through a VersionWatcher on the fused_serve
             and the cross_stack stacks: torch.cuda.memory_allocated before
             the load and after the retire (once the batcher's threads let
             go of its last batch and that thread has freed it, at most
             10 s; cuBLAS workspaces cleared before both reads), which must
             match within 1 MiB.

7. outputs — the response path (ops/transfer.py readback wire,
             serving/service.py PredictStream, the UDS listener) on the
             bf16 fused_serve configuration of configs/latency.toml, seed-0
             weights. Six in-process batchers (max_wait_us = 0): no wire,
             output_wire_dtype float32 / bfloat16 / float16 / int8, and
             output_top_k = 100, each answering n = 7, 1000 and 2048. Each
             result must be exactly its wire's result of the no-wire
             batcher's scores: float32 the same bits; bf16 / f16 the scores
             rounded to that dtype; int8 the dequantization of a host
             quantization of the padded float32 output with the reference's
             arithmetic (and q, scale and min read back raw must equal it);
             top-k the same head indices as a stable descending sort, their
             scores, zeros elsewhere, 800 bytes read back per top-k batch.
             Every result within 5e-3 plus its wire's rounding of the plain
             forward. Printed per wire and bucket: d2h_issue (transform +
             copies) and d2h_wait (event + host restore), median of 20, and
             the bytes read back against a float32 readback of every
             output; and the issue must return while the card is still busy
             with a queued torch.cuda._sleep (the wire adds no host sync). Then a gRPC server with [kernels] enabled (float
             variants) and int8_score_wire, stream_chunk_candidates = 256
             and a Unix-domain socket: a Predict with x-dts-score-wire:
             int8 must answer DT_INT8 plus both sidecars within range/508 of
             the float response; PredictStream at n = 2048 in chunks of 256
             and of 512 (x-dts-stream-chunk) must cover the request once,
             one chunk final, every score within 5e-3 of the plain forward;
             printed: time to the first and to the last chunk against unary
             Predict p50 (20 each), and the GetModelMetadata floor p50 over
             TCP and over the socket. fused_serve/bfloat16 must launch.

8. families — the other model families (wide_deep, deepfm, generic, dlrm,
             two_tower) at the full width of configs/latency.toml [model]
             (DLRM: 13 dense features, bottom MLP 64/32/16; two_tower: 8 user
             fields), seed-0 weights, buckets 128/512/1024/2048/4096/16384.
             Per family, in bf16 and in f32, build_stack (model_kind = the
             family) serves its BASELINE.json size (wide_deep 128, deepfm
             512, generic 1000, dlrm 4096 with dense_features, two_tower
             10 000 in bucket 16384) through DynamicBatcher.submit: scores
             within 1e-5 of the card's model.apply on the same padded batch,
             and in f32 within 2e-5 of the CPU's forward of the same params.
             Printed per family and dtype: the eager device step (one call,
             CUDA events; the profiler's device time; kernels per call). The
             bf16 stack arms [kernels]: its autotune table is printed
             (xla_int8 measured per bucket; the fused variants ineligible
             with the JAX package's reason, or the run fails), then 20 gRPC
             Predicts at the family's size: p50 and the card's busy share,
             every response within 1e-5 of the card's model.apply. two_tower
             with output_top_k = 100 must return the head of a stable
             descending sort of its full scores. Neither CUDA kernel may
             launch during the phase (they serve dcn_v2 alone).

9. models — multi-model serving (serving/server.py ModelLifecycle,
             HandleReloadConfigRequest, GracefulShutdown, the request log).
             save_servable writes CTR (dcn_v2 bf16, seed 0), CTR_F32 (dcn_v2
             f32, seed 1) and RANKER (deepfm, seed 2) at the [model] width of
             configs/latency.toml, and NEW (dcn_v2 bf16, seed 3), into a
             temporary directory; a models.config lists the first three
             (CTR with version_labels { stable: 1 }) and a batching-parameters
             file restates the ladder (256-2048) and the 200 us wait. The CLI
             server starts with --config configs/latency.toml
             --model-config-file, --batching-parameters-file, --request-log-file
             (sampling 1.0) and a 0.5 s poll. 4 client threads send Predicts
             (n = 1000 to CTR by label stable and to CTR_F32, 512 to RANKER,
             1000 to NEW once added) while a reload adds NEW, CTR v2 (seed 4)
             is written, and, once GetModelStatus shows it AVAILABLE, one
             reload moves stable to 2 and drops RANKER; then SIGTERM during
             the traffic. Checks: no failed request on CTR, CTR_F32 and NEW;
             RANKER only OK before its drop and only NOT_FOUND after it;
             stable names v1 before the relabel and v2 after it; every
             response within 5e-3 (bf16) / 2e-5 (f32) of the card's plain
             forward of the model and version it names; after SIGTERM only OK
             or UNAVAILABLE, the server exits 0 with drained=True, and its
             shutdown line counts fused_serve/bfloat16 and float32 launches;
             every request-log record a Predict of a listed model, the first
             200 replayed through replay_warmup_file; in this process
             build_stack on the same file, where taking CTR_F32 out, in (one
             request) and out again leaves torch.cuda.memory_allocated within
             1 MiB. Printed: p50 / p99 per model before the reloads and after
             the relabel, each reload's time, add -> first NEW response,
             relabel -> first v2 response, the drain, the launch counts.

10. rest  — the REST gateway and the telemetry plane (serving/rest.py,
             utils/metrics.py, utils/tracing.py): configs/latency.toml with
             [kernels] enabled (its own table, kernel_autotune_rest.json),
             seed-0 weights. First in this process: build_stack on that
             config (its autotune writes the table the CLI servers adopt)
             with the gateway over it; the launch counters zeroed just
             before 5 REST Predicts per size (7, 1000, 2048) and read just
             after, under torch.profiler: every batch launches the fused
             serve kernel and no GEMM runs (a window in which the profiler
             dropped a kernel event is measured again, at most 3). Then the CLI server with
             --rest-port, --tracing and --metrics-every-s 1: one client at a
             time sends 10 gRPC Predicts per size and the same payloads as 10
             REST Predicts per size in the row and 10 in the columnar format
             (each REST response bit-identical to the gRPC one, every score
             within 5e-3 of the card's plain forward on the tree the bucket's
             decision picked), 5 REST Classify of n = 7 Examples, and one REST
             and one gRPC Predict with a known traceparent. Checks:
             /monitoring counts REST.Predict, REST.Classify and Predict
             exactly as sent and has batcher, pipeline, kernels and phases
             blocks (batch.cache, batch.jitcall, readback.wait counted);
             the Prometheus text passes tools/check_prom.py and carries the
             REST.Predict request_count and dts_tpu_kernel_* lines; /tracez
             holds both trace ids (roots server.REST.Predict and
             server.Predict) with predict.decode / execute / encode and the
             replayed batch.* / readback.* phases as children;
             /tracez?format=chrome parses; the log has a `metrics {...}`
             line; SIGTERM exits 0. Printed: REST p50 / p99 per size and
             format against gRPC p50, the share of a REST Predict outside
             decode / execute / encode (from the span trees), and gRPC p50
             at n = 7 and 1000 with --tracing and, on a second server of the
             same tree, without it.

11. aio   — the coroutine gRPC server and the batcher's failure paths:
             build_stack with [kernels] adopting the rest phase's table and
             [transport] response_arena, the aio and a sync server on one
             impl (20 Predicts per size 7 / 500 / 1000 / 2048, every aio
             answer bit-identical to the sync one; Classify / Regress;
             PredictStream n = 2048 in 256-row chunks), launches counted over
             those requests (each kernel the adopted decisions route to, and
             no other), a closed loop of 500 Predicts
             of n = 1000 at 4 and 16 clients (sync / aio / aio / sync), the
             wedge breaker at 2 s on a second stack with no plane
             (UNAVAILABLE in under a second, the queued call too; the float
             kernel launched), each fault site's status code,
             inflight_window = 1 under 4 clients of n = 2048 and buffer_ring
             on dcn_v2 in f32.

12. cache — the cache plane (cache/, serving/batcher.py's score cache,
             row cache, dedup and DeviceInputCache, [cache], /cachez): two
             stacks from build_stack on configs/latency.toml with [kernels]
             adopting the rest phase's table, one with [cache] enabled,
             dedup and row_granular, one without, each on a sync gRPC server;
             a zipfian catalog of 4096 rows (ids uniform in [0, 2^20),
             weights uniform, skew 1.2) from the seed. In order: (1) a fresh
             n = 1000 Predict and 5 repeats: the repeats answer its bits, run
             no batch, count >= 5 hits; (2) one fresh payload from 8 threads
             while a `delay` rule holds the leader's dispatch 0.2 s: one
             batch, >= 7 coalesced, 8 identical answers; (3) A = 1000
             catalog rows, then B = A's first 900 + 100 fresh rows: B runs
             100 rows in bucket 256 (rows_executed +100, padded_candidates
             +256), its hot rows have A's bits, its cold rows the bits of the
             cache-off server's Predict of those 100 rows; B reversed is a
             full row hit (row_full_hit_batches +1, no batch, no launch);
             (4) 2048 rows over 200 fresh distinct rows: 1848 collapsed,
             bucket 256, the bits of the cache-off server's Predict of the
             200 distinct rows (in the batch's digest order) scattered back;
             every answer within 5e-3 of the plain forward on the tree each
             bucket's decision picked; the launch counters, zeroed before (1)
             and read after (4), less the launches of the two cache-off
             reference Predicts of (3) and (4), give `launches_cache`, and
             every kernel the decisions of the buckets used pick must have
             launched; (6) on the cache-off stack 20 x one n = 2048 payload
             (>= 19 input-cache hits, copies + hits = batches, identical
             answers), 20 distinct n = 2048 payloads (20 misses), then,
             re-armed, 70 distinct n = 256 payloads (the bypass engages, the
             store is empty); printed: batch.cache per batch on a hit and on a
             miss (median and extremes) beside the native pack and the H2D
             copy of a batcher without the cache;
             (7) 4 clients x 250 Predicts of n = 1000 drawn from the catalog
             (one seeded stream, replayed by every run; each cache-on run
             starts from flushed stores), cache off / on / on / off: p50,
             p99, QPS, hit rates and rows_executed / rows_requested,
             recorded; (5) version 2 (seed
             1) loaded through the server's own watcher (its hook
             invalidates both stores): invalidations > 0, and the next
             repeat of (1) runs one batch and answers version 2 (after (7),
             which compares the stacks on version 1); (8) the REST gateway
             in process: /cachez equals cache_stats() with row_cache_stats(),
             dts_tpu_cache_hits_total the snapshot's hits, POST
             /cachez/flush drops every entry and the next repeat misses.

13. integrity — the integrity plane (serving/integrity.py, the codec's CRC32C
             sidecars): four stacks from build_stack on configs/latency.toml
             with [integrity] enabled, wire_checksums, screen and
             shadow_fraction = 1.0 ([cache] off): bf16 and f32 with
             [kernels] (no autotune: each bucket's decision pinned to the
             float and then the int8 fused serve kernel), and bf16 and f32
             use_pallas_cross. (a) At each bucket 256 / 512 / 1024 / 2048 a
             Predict that fills it, per stack and variant: every answer the
             bits of the same stack's answer with the plane detached
             (`batcher.integrity = None`, sent first and counted apart),
             shadow batches = batches, 0 mismatches, and each of the six
             (kernel, dtype) launch counters, zeroed just before, at 2 x its
             primary batches (`launches_integrity`). (b) readback_bitflip
             keyed on one payload's poison_fault_key: its Predict fails
             UNAVAILABLE, 1 mismatch, 1 escalation, suspect; 3 clean shadows
             clear it. (c) score_nan keyed on one request of a coalesced pair
             (shadowing off): only it fails UNAVAILABLE, its batchmate keeps
             the fault-free bits, screen.trips + 1. (d) Over gRPC, stamps made
             with the port's codec.crc_sidecar: a clean stamp verifies, one
             wrong hex digit fails INVALID_ARGUMENT alone beside a concurrent
             clean twin, every x-dts-score-crc verifies; a DT_BFLOAT16
             feat_wts stamped over its wire bits (crc32c of the "<V2" header
             and the bits, as a bf16 sender stamps) answers OK with the bits
             of its float32 twin, and one flipped bit of it fails
             INVALID_ARGUMENT corrupt-wire; predict.decode at
             n = 2048 with and without a stamp (off / on / on / off).
             (e) /integrityz, POST /integrityz/audit?batches=2 (two batches
             shadowed at shadow_fraction 0), ?section=integrity, >= 11
             lint-clean dts_tpu_integrity_* lines. (f) 4 x 250 Predicts of
             n = 1000 at shadow_fraction 0 / 1 / 1 / 0: p50, p99, QPS, busy
             share and the batch.shadow_dispatch mean, recorded.

14. overload — the overload plane (serving/overload.py): configs/latency.toml
             with [overload] enabled, target_queue_wait_ms = 5,
             queue_wait_window_s = 2, adjust_interval_s = 0.1, on the
             threaded gRPC server. (a) 16 clients in 4 processes of their
             own x 150 Predicts of n = 2048 (8 payloads, tensor_content),
             50 ms deadline each, half `x-dts-criticality: sheddable` and
             half `critical`, a refused client sleeping the retry-after-ms
             it was sent; plane off / on /
             on / off (`batcher.overload` detached for off): on, at least one
             shed, every refusal's retry-after-ms in [25, 2000], the state
             leaves NOMINAL, the sheddable lane's refusal share >= the
             critical lane's; every admitted answer the bits of the plane-off
             answer; then 1 Predict per 50 ms until NOMINAL (at most 30 s).
             Recorded: admitted answers with their p50 (p99 from 100 on),
             answers in time and goodput, the server's predict.decode /
             execute / encode means, codes per lane, sheds, doomed
             refusals, the final limit, the states seen, the launches of
             the on runs (`launches_overload`). (b) On a stack with
             [cache] enabled and row_granular (TTL 0.5 s), the `pressure`
             site pinning BROWNOUT: an expired request answers stale with
             x-dts-degraded: stale, its cached bits, no launch, no refill; 900
             expired rows + 100 fresh answer with the mark. (c) pinning SHED:
             sheddable refused RESOURCE_EXHAUSTED with retry-after-ms,
             critical admitted; over REST 429 with Retry-After, and a stale
             answer with X-DTS-Degraded. (d) /monitoring?section=overload and
             the lint-clean dts_tpu_overload_* series equal overload_stats().

15. cascade — the ranking cascade (serving/cascade.py): configs/latency.toml
             with [cascade] enabled (stage 1 the in-process two_tower
             `stage1`, survivor_fraction 0.25, min_candidates 8; the shadow
             off) beside a plane-off stack, both seed 0, bf16 fused serve, on
             threaded gRPC servers. (1) Four output-filtered Predicts (n =
             1000, 1000, 2048, 2048): int32 cascade_stage with plan_k(n) rows
             ranked; the ranked rows are the stable top-k of a direct
             Predict to `stage1` over the same rows; survivor scores the bits
             of a plane-off Predict of the survivor rows alone, pruned rows
             the bits of that stage-1 Predict; all within 5e-3 of the plain
             forward (model.apply of each stage) on the card; the
             fused_serve/bfloat16 launches, zeroed just before and the
             references counted apart, one per Predict and no other kernel
             (`launches_cascade`); prune_batches + 4, prune_fallback_batches,
             host_prunes and fallbacks + 0. (2) n = 7 and an unfiltered
             Predict carry no cascade_stage and the plane-off bits. (3)
             /cascadez = /monitoring?section=cascade = cascade_stats(), the
             lint-clean dts_tpu_cascade_* lines name the requests and rows
             sent. (4) 100 Predicts of n = 2048, off / on / on / off: p50,
             p99, the cascade.stage1 / prune / stage2 means and
             survivor_buckets, recorded. (5) Stage 1 unloaded: a Predict
             answers OK with provenance all 2, the plane-off bits, fallbacks
             + 1.

16. utilization — the utilization and quality planes
             (serving/utilization.py, serving/quality.py): the serving
             phase's breakdown `device_step` per bucket (synchronized: the
             step's launch and kernel with the card idle before it, median
             of 20) is written as {bucket: us} to
             chiprun_out/device_step_us.json; the CLI server on
             configs/latency.toml (bf16 fused serve, seed-0 weights) with
             --utilization --quality --tracing --rest-port, [utilization]
             calibration_file = that table, and a [quality] window of 2 s
             (4 slices, drift checked every 0.25 s). (1) 4 client processes
             x 250 gRPC Predicts of n = 1000 (one payload each), then
             /utilz over the loop's window: its components sum to its wall
             within 2 %, its batches = the ledger's = the batcher's
             non-warmup batches over the loop, in_flight 0, every idle cause
             >= 0, achieved_fraction_of_device_limit in (0, 1] and labelled
             device_step_table. (2) During a second loop, POST
             /profilez/start?seconds=1: device_trace true, a second POST
             answers 409, the exported trace names fused_serve_bf16_kernel,
             host_stacks.json names the batcher, dispatch and completion
             threads (kept as chiprun_out/utilization_host_stacks.json, the
             dispatch thread's commonest stacks printed); the kernels'
             busy time in the trace (the union of their intervals) must be
             at most the ledger's busy time over a window from the POST to
             the capture's end. (3) POST
             /qualityz/snapshot, 2.5 s for the window to turn over, then 10
             Predicts of the 50 rows of a loop payload that scored highest,
             repeated to n = 1000: the reference PSI above
             drift_threshold_psi, exemplars marked, a /tracez span annotated
             quality.drift. (4) 4 Predicts with a known traceparent each, 250
             rows of each labelled (Bernoulli of the score, seeded), POST
             /labelz by trace id: all joined, and the windowed AUC equal to
             train/data.auc over the same pairs (rounded to 6 places, as
             /qualityz rounds it) within 1e-12. (5) /qualityz's lifetime
             count = every score the server answered in the phase, its 50
             bins = the clients' histogram of those scores on the sketch's
             edges, exactly. (6) The dts_tpu_utilization_* and
             dts_tpu_quality_* lines pass tools/check_prom.py; SIGTERM
             exits 0. (7) The same loop, at 60 Predicts per client, on an
             in-process stack of the same configuration with both planes,
             detached for off: off / on /
             on / off, then utilization / quality / quality / utilization
             (one plane attached), p50, p99 and QPS; the uncontended host
             cost of one observe of 1000 scores and of one ledger interval;
             the on runs' launch counters
             (zeroed just before, read just after: `launches_utilization`)
             must show fused_serve/bfloat16 once per batch and nothing
             else.

17. freshness — the continuous-freshness loop (train/trainer.py,
             train/publisher.py, serving/lifecycle.py) out of process. (1)
             The trainer CLI trains v1 on the card at the [model] width of
             configs/latency.toml (dcn_v2 bf16, 150 steps of 512 rows of the
             synthetic stream, id space 16384, rate 1e-2) into base/1:
             examples/s, final loss, held-out AUC beside the Bayes AUC (in
             (0.5, Bayes]). (2) 3 f32 train steps of a small dcn_v2 from the
             same params on the card and on the CPU: losses within 1e-5.
             (3) The CLI server on configs/latency.toml with
             --model-base-path base --lifecycle (which arms [quality])
             --rest-port, a 0.25 s poll, [lifecycle] tick 0.1 s, probe-only
             1 s, ramp 0.5 at once, promote_after 2 s, min_canary_scores
             4000, the fine-tune publisher every 8 s (100 steps of 256, rate
             1e-4; its PSI / AUC gates set wide, the fine-tune trains on
             another teacher by design): 4 client processes send
             closed-loop Predicts of n = 1000 (every 10th on the probe
             lane) while the server fine-tunes v1 on its lifecycle thread,
             publishes v2, hot-loads, canaries and promotes it; 8 labelled
             Predicts of 200 rows (4 probe, 4 default) post their labels to
             /labelz (all joined). Checks: 0 failed Predicts; v1's scores
             for a fixed payload of 2048 rows (the top bucket: never
             coalesced) pinned to v1 bit-identical before and after
             the fine-tune; in the probe-only phase the probe lane answers
             from v2 and the default lane from v1; at the 0.5 ramp the
             controller's routes alternate (|canary - stable| <= 1) and the
             clients' default-lane answers split within the requests in
             flight; /lifecyclez, /monitoring?section=lifecycle and the
             lint-clean dts_tpu_lifecycle_* series agree with the events;
             fused_serve/bfloat16 launched on each version (the server's
             counts at each version change and at shutdown); SIGTERM exits
             0. Printed: the fine-tune's steps/s and publish time inside the
             server, Predict p50 / p99 while it trains against before it,
             publish -> canary and canary -> promote, the clients' and the
             controller's ramp shares, the judgment at promotion. (4) v2
             read back onto the card: the fused serve kernel against its
             plain version at n = 2048 (5e-3) and against the server's v2
             answer to that payload (5e-3). (5) A second server, publisher off: a version
             published from outside with the head's bias +20 is canaried
             and rolled back (PSI >= 0.5 at the defaults), retired,
             blacklisted and not reloaded by the next reconcile passes;
             POST /lifecyclez/rollback answers 409; 0 failed Predicts;
             printed: publish -> canary -> rollback. `launches_freshness`:
             both servers' counts from start to exit.

18. recovery — the device-failure recovery plane (serving/recovery.py) out
             of process: two CLI servers on configs/latency.toml (bf16 fused
             serve, seed 0) with --recovery --rest-port and [recovery]
             watchdog_interval_s = 0.1, wedge_quarantine_s = 1.0, started
             together. Server R (DTS_TPU_FAULTS: a keyless device_lost
             count=1 rule at rate 0.002, a DATA_LOSS rule keyed on a poison
             payload, a 0.5 s delay keyed on a blocker payload): (1) 4 client
             processes x closed-loop Predicts of n = 1000 (a refusal while
             quarantined is retried after 5 ms) until the keyless rule's
             cycle is done, and 2 s more: 0 failed Predicts, one quarantine,
             replayed_items >= 1, health "" (checked on a thread as fast as
             it answers) NOT_SERVING in at least one check inside the cycle,
             SERVING in every one after it, every NOT_SERVING with the
             quarantined reason; printed: the MTTR
             (last_cycle.duration_s), p50 / p99 before, during and after
             the cycle, the health checks that landed inside it. (2) The
             blocker holds the dispatch stage while a second payload waits
             staged, so the poison (n = 100) and two clean companions queue
             and coalesce: only the poison fails, INVALID_ARGUMENT with
             "bisection" in its details, the companions (and the blockers)
             within 5e-3 of the plain forward, bisections >= 1. /recoveryz,
             /monitoring?section=recovery and >= 17 lint-clean
             dts_tpu_recovery_* lines agree. Server W (a batcher.dispatch
             wedge, count 1, held 3 s; a 2 s delay keyed on a stall
             payload): (3) its first Predict wedges, the watchdog trips
             (trigger wedge), the dispatch thread and the completion pool
             are replaced, the Predict is answered once by the replay within
             5e-3, and the wedged thread's late result is dropped (its log).
             A 2048-row payload (the top bucket: never coalesced) scores the
             same bits on R before any fault, after each of R's cycles and
             on W after its REINIT. (5) The stall payload trips a cycle
             whose replay stalls too: health "" is NOT_SERVING (quarantined)
             in every check inside it; SIGTERM during its REPLAY exits 0
             within drain_grace_s and the replayed Predict answers.
             Every re-warm logs its launches: fused_serve/bfloat16 must
             launch in each; `launches_recovery` is both servers' counts from
             start to exit. (4) A child process (`chip_smoke.py
             --recovery-child OUT`): an in-process stack with the plane
             armed serves 4 Predicts, then one fused serve launch with ids
             2^31 - 1 (no allocation there) faults its context for good;
             torch's error at the synchronize, and the failure the batcher
             hands to take_group, must read as device_fatal; the probe's
             verdict (context lost) within 1 s of REINIT; the 4 Predicts
             sent after the fault end UNAVAILABLE (at least one captured,
             "context lost"), poisoned_requests 0, the controller holds
             QUARANTINED (health NOT_SERVING, quarantined; a later Predict
             refused UNAVAILABLE), the drain returns within 5 s and the
             child exits 0 within 180 s. Printed: the error texts and the
             time to the verdict.

19. savedmodel — the SavedModel intake (interop/savedmodel.py,
             interop/graph_exec.py): a dcn_v2 export of the seed-0 demo
             weights at the width of configs/latency.toml, written with the
             vendored protos (serve tag; serving_default feat_ids DT_INT64
             [-1, 43], feat_wts DT_FLOAT [-1, 43] -> prediction_node; a
             variables/variables.index placeholder; the weights under
             Keras-style names in a fresh variables_extracted.npz, as the
             card's machine has no TensorFlow to extract them). A CLI server
             `--savedmodel` on it beside a `--checkpoint` server on its
             conversion (`python -m ...interop.savedmodel DIR OUT`): Predicts
             of n = 7, 1000 and 2048 on both, the two servers' n = 2048
             scores bit-identical, every score within 5e-3 of the plain
             forward, and fused_serve/bfloat16 launched by the import
             server's Predicts (its launch count at shutdown less the one
             it logged when ready). A `--model-base-path` server on a base
             path of SavedModel versions: v1 (seed 0) loads, v2 (seed 1) is
             published (renamed in) under 2 client threads of n = 1000
             Predicts, which must see v2 with 0 failed Predicts, each
             response within 5e-3 of its version's plain forward, and
             fused_serve/bfloat16 launched by v2's Predicts (the count at
             shutdown less the one logged at v2's load). A graph
             export (int64 ids -> FloorMod 2^20 -> a [2^20, 16] embedding
             variable gathered and weighted -> Shape / StridedSlice / Pack /
             Reshape to [n, 688] -> MatMul / BiasAdd / Relu at 256 / 128 / 64
             -> MatMul to 1 -> Squeeze -> Sigmoid, and the ids' row sums as
             a second output), its variables placed in the port's own graph
             cache, served with `--model-kind graph`: ids past 2^31 arrive
             intact (the row sums exact) and scores are within 1e-5 of the
             port's executor on the CPU; in a child process (`chip_smoke.py
             --graph-calls DIR OUT`: this process's profiler loses events
             after the earlier phases) one warm model.apply on the card runs
             under torch.cuda.set_sync_debug_mode("error"), and the
             profiler must see its launches. Printed: the import's
             pb parse / npz load / map / CUDA context / H2D, the first
             Predict, the p50 at
             n = 1000 of the import server against the checkpoint server,
             the swap's publish -> first v2 response, and the graph
             executor's p50 and launches per call at n = 1000 and 2048.
20. fleet — the sharded fan-out client and the fleet tier (client/,
             fleet/): v1 (seed 0) written with save_servable at the full
             width of configs/latency.toml into a shared base path; three
             replica CLI servers (`--fleet`, [lifecycle], trace export,
             REST, gossip every 0.25 s) started in parallel, then one
             `--router` process (its [client] hosts the three, contiguous
             placement, rollout_writer, [slo] on, [integrity]
             router_audit_fraction 0.05). Traffic off: the same
             n = 1000 payload through the router, through the direct
             sharded client over the three replicas (the reference's own
             fan-out) and unsplit to one replica, 30 times each: the
             direct scores within 5e-3 of the plain forward, the router's
             the bits of the direct ones (the same rows to the same
             replica), p50 / p99 printed. Two spawned edge client
             processes (the port's ShardedPredictClient, hosts = [router],
             2 loops each of n = 1000 Predicts with a 100 ms pause between
             them (the JAX package's fleet soak pauses 20 ms; this pace
             leaves the router headroom, PERF.md §6), traced) drive the
             router while one replica is SIGKILLed (0 edge errors, every
             1 s goodput window until the canary publish at least 0.5 of
             the steady median, kill -> first rerouted answer printed) and
             restarted under its id (back `serving` in the router's
             /fleetz with healthy_backends 3 within 45 s); until the
             canary publish, the router's audits of the edge's requests
             (one request to two replicas, bit for bit) number > 0 and
             flag no mismatch; v2 (seed 1) is
             published, live on every replica, rolled back through one
             replica's POST /lifecyclez/rollback, blacklisted by the
             router and rolled back on every replica within one gossip
             interval plus 1 s, 0 Predicts failing; the score checks
             again. The router's /tracez holds a stitched trace of >= 3
             processes whose waterfall closes within 2 %,
             /fleet/monitoring's qps is within 5 % of its members' sum,
             /sloz's burn rates are finite, and dts_tpu_fleet_* series on
             the router's /metrics and a replica's exposition pass
             tools/check_prom.py. Each replica's served
             fused_serve/bfloat16 launches (its log: the count at shutdown
             less every version's warmup, from the line before it to the
             version change after it) must be > 0, the restarted one's too,
             and each logs device cuda. `chip_smoke.py --fleet-only` builds
             the kernels and runs this phase alone (the edge pause from
             the environment's FLEET_EDGE_PAUSE_S), printing its result.
21. mesh  — serving over a mesh (parallel/, the batcher's run_fn hook,
             [mesh] / [elastic], serving/multihost_server.py) on one card:
             configs/latency.toml's dcn_v2 with use_pallas_cross, one
             save_servable checkpoint (seed 0; v2 seed 1). Every server
             process starts at once. (1) A CLI server with [mesh] enabled,
             devices = 1 and an in-process plain server (fused serve kernel
             off), both on model.apply and the cross-stack kernel: filtered
             Predicts of n = 7, 1000 and 2048 answer the same bits, the
             plain ones those of the plain forward on the card. (2) In
             process, ShardedExecutor over logical (2, 2), (4, 1) and
             (1, 4) meshes of cuda:0 (vocab-sharded, EP) at 5, 1000 and
             2048 rows, filtered and unfiltered: the bits of each data
             shard's rows scored alone on the card (exact), against the
             single-device bits (bit equality: a row's bits do not move
             with its shard's row count; `row_count_faults` stays empty;
             before step 1, while the servers start, the eager products of
             the forward in calls of 2048 ... 250 rows, one library call
             against models/base.py's fixed row tiles, and the whole
             forward, tools/torch_row_count.py); each call launches the cross
             stack once per data shard; the int8 wire over the pad (5 rows
             on 2 data shards) is exactly the host round trip of the
             unpadded scores; TP at (2, 2) in f32 (the f32 cross stack
             under the weight all-gather) within rtol 1e-5 of the
             replicated layout; ms per 2048-row batch at (2, 2) against a
             1 x 1 mesh. (3) An in-process elastic stack (ladder 4x1 / 2x2 /
             1x4 over four logical shards of cuda:0, from 1x4, [overload]
             on) under 4 spawned clients of n = 2048 (the top bucket: no
             two requests coalesce): the `pressure` fault site pinned
             BROWNOUT drives it up to 4x1, pinned NOMINAL with the clients
             paced 0.5 s down to 1x4; the history must read 1x4 -> 2x2 ->
             4x1 -> 2x2 -> 1x4 with every drain recorded, 0 Predicts fail,
             every answer is the bits of one split's shards for its payload,
             and the dts_tpu_elastic_* series pass tools/check_prom.py. (4)
             multihost_server at world size 1 (NCCL) answers the plain
             server's bits; two processes on cuda:0 (gloo) answer the bits
             of their two row blocks, reload v2 through the leader's watcher
             under paced Predicts (every 20 ms, 0 failed), and release the
             follower on the leader's SIGTERM (both exit 0); a second gloo
             pair's SIGKILLed follower makes its leader exit nonzero within
             20 s (2 x HEARTBEAT_TIMEOUT_S). (5) With the other processes
             gone, n = 1000 Predict p50 of the [mesh] server against the
             plain one (in turns), its /meshz (shape 1 x 1, batches,
             layout rules:dcn_v2) and dts_tpu_mesh_* series (lint-clean),
             and its served launches (the cross stack, no fused serve).
             Results in chiprun_out/mesh.json; `chip_smoke.py --mesh-only`
             builds the kernels and runs this phase alone.
22. trainmesh — training over a mesh (train/trainer.py mesh= /
             tensor_parallel=, parallel/sharding.py's trainable placement)
             on one card: configs/latency.toml's dcn_v2 width with
             use_pallas_cross off (the kernel has no backward), seed-0
             params, 20 steps of 2048 rows of the synthetic stream, in f32
             and bf16: one device, then logical meshes of cuda:0 (4, 1) dp,
             (2, 2) dp + ep, (1, 4) ep and (2, 2) dp + ep + tp. Every step's
             loss within rel 2e-4 (f32, the JAX test's) / 1e-3 (bf16) of the
             one-device run's; every leaf's replicas bit-equal after the
             last step; the embedding at (model, None) and, with TP,
             mlp[0].w at (None, model) after the updates; steps/s and
             examples/s from step 2 on. The bf16 (2, 2) TP snapshot, saved,
             answers Predicts of n = 1000 and 2048 through a 1 x 1 [mesh]
             server (gRPC) with the bits of (2, 2) ShardedExecutors, TP off
             and on, over load_servable(mesh=). The trainer CLI with
             --mesh-devices 1 (20 steps of 2048) trains on the card and its
             checkpoint serves finite scores. No kernel is launched.
             Results in chiprun_out/trainmesh.json; `chip_smoke.py
             --trainmesh-only` builds the kernels and runs this phase alone.

The lifecycle and models phases clear the device input cache before each
memory read (its entries belong to the batcher, not to a version) and print
the bytes it held.

Prints one `{"kernels": [...]}` line (one entry per kernel and compute
dtype, the f32 ones named `<kernel>_f32`: the rule row at 2048 rows; the
main paths' launches, `launches` = the serving phase's plus the outputs
phase's (`launches_serving`, `launches_outputs`), each path's counters
zeroed just before it and read just after; the lifecycle path's launches
(`launches_lifecycle`); and every row under "by_shape"; the families
phase launches none; the models server's count from its start to its exit,
`launches_models`; the REST path's, `launches_rest`, and the REST CLI
server's from its start to its exit, `launches_rest_server`; the aio
path's (the plane stack's requests and the breaker stack's),
`launches_aio`; the cache-on stack's over the cache phase's steps
1-4, `launches_cache`; the integrity phase's shadowed run,
`launches_integrity`; the overload phase's armed load runs,
`launches_overload`; the cascade phase's eligible Predicts,
`launches_cascade`; the utilization phase's plane-on runs,
`launches_utilization`; the freshness phase's two servers,
`launches_freshness`; the recovery phase's two servers,
`launches_recovery`; the savedmodel phase's import server over its
Predicts, `launches_savedmodel`, and its base-path server from v1's load to
its exit, `launches_savedmodel_base`; the fleet phase's three replicas'
served launches, `launches_fleet`; the mesh phase's, `launches_mesh`: its
[mesh] CLI server's and multi-process servers' served launches, its logical
meshes' calls and its elastic run), the
nvidia-smi line, and last `{"ok": true, "device": {...}}`. Every line it
logs is also kept in chiprun_out/chip_smoke.log.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "distributed_tf_serving_tpu_torch"

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# f32 (non-tensor-core) FLOP/s, TF32 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TF32_FLOPS = 494.7e12
# The f32 kernels' TF32 mmas per f32 product (split TF32): hi*hi, hi*lo and
# lo*hi, or two where the weight is int8 (exact in TF32, no lo part).
SPLIT_TF32_PRODUCTS = {False: 3, True: 2}  # keyed by "the weights are int8"
SERVE_TOL = {"float32": 2e-5, "bfloat16": 5e-3}
CROSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
APPLY_TOL = 5e-3
BUCKETS = (256, 512, 1024, 2048)  # configs/latency.toml
CLUSTERS = (1, 2, 4, 8)
CROSS_PLANS = tuple((r, c) for r in (16, 32) for c in CLUSTERS)  # (rows per block, cluster)
KERNEL_NAMES = {  # (wrapper's counter, compute dtype) -> ptxas entry name
    ("fused_serve", "bfloat16"): "fused_serve_bf16_kernel",
    ("fused_serve_int8", "bfloat16"): "fused_serve_int8_bf16_kernel",
    ("fused_serve", "float32"): "fused_serve_f32_kernel",
    ("fused_serve_int8", "float32"): "fused_serve_int8_f32_kernel",
}


def cross_kernel_name(cd: str, rows: int) -> str:
    return f"cross_stack_{'bf16' if cd == 'bfloat16' else 'f32'}_kernel<{rows}>"
SEED = 0


# Every line log() and fail() print, kept whole: a command's output comes
# back cut to its end, and the kernels line alone can fill that.
LOG_FILE = os.path.join(HERE, "chiprun_out", "chip_smoke.log")


def _keep(line: str) -> None:
    if os.path.isdir(os.path.join(HERE, PKG)):
        os.makedirs(os.path.dirname(LOG_FILE), exist_ok=True)
        with open(LOG_FILE, "a") as f:
            f.write(line + "\n")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    _keep(f"chip_smoke: FAIL: {msg}")
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)
    _keep(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Time of one wrapper call as the serving path pays it: the median of
    `iters` CUDA-event pairs, each around a single call, so the wrapper's
    host time is in it where it exceeds the kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def loop_ms(fn, iters: int = 50, runs: int = 3, warmup: int = 5) -> float:
    """Time of one call in a run of `iters` back-to-back calls: CUDA events
    around the run, over the count; the median of `runs` runs. Launches
    overlap the previous call's kernel, so the wrapper's host time drops
    out where the kernel takes longer."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / iters)
    return statistics.median(times)


def device_ms(fn, iters: int = 20, attempts: int = 3, tries: int = 8) -> float:
    """Device time of one call from torch.profiler: the summed device time
    of every kernel the call launched, over the count; the median of
    `attempts` profiles that saw device time, out of at most `tries`, since
    the tracer sometimes drops part of a window or all of it. A run in
    which no profile saw device time fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        if len(seen) == attempts:
            break
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(
            getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            for e in prof.key_averages()
        )
        if busy_us > 0:
            seen.append(busy_us / iters / 1e3)
    if not seen:
        fail(f"torch.profiler recorded no device time in {tries} profiles of {iters} calls")
    return statistics.median(seen)


def check_build(src: str, info: dict) -> dict:
    """Print each kernel's registers and spills from ptxas; fail on a spill
    or a kernel over 128 registers. Returns {kernel: {"registers",
    "spill_bytes"}}."""
    import re

    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    log(f"build: {src} nvcc {info['seconds']:.2f} s; " + " | ".join(regs))
    if not regs:
        fail(f"no ptxas register report for {src} (a library reused without its build log)")
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", info["log"])]
    if any(spills):
        fail(f"ptxas reports spills in {src}: " + " | ".join(ln for ln in regs if "spill" in ln))
    # Registers per kernel: ptxas names each entry function (mangled, with
    # the cross kernel's rows per block as its template argument) before
    # its "Used N registers" line.
    per_kernel, entry, spill = {}, None, 0
    for ln in info["log"].splitlines():
        m = re.search(r"Compiling entry function '[^']*?((?:fused_serve|cross_stack)_\w+?_kernel)"
                      r"(?:ILi(\d+)E)?", ln)
        if m:
            entry, spill = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else ""), 0
        spill += sum(int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            per_kernel[entry] = {"registers": int(m.group(1)), "spill_bytes": spill}
    log("build: registers per kernel: " + ", ".join(
        f"{k} {v['registers']}" for k, v in sorted(per_kernel.items())))
    want = {*KERNEL_NAMES.values(),
            *(cross_kernel_name(cd, r) for cd in PEAK_FLOPS for r in (16, 32))}
    if not want <= set(per_kernel) or max(v["registers"] for v in per_kernel.values()) > 128:
        fail(f"ptxas register report of {src} lacks a kernel or exceeds 128: {per_kernel}")
    return per_kernel


def timings(fn, plain_fn) -> dict:
    """The kernel's and its plain version's times, three ways each: one
    call (`ms`, as the serving path pays it), back to back (`loop_ms`), and
    the device time from the profiler (`device_ms`)."""
    return {
        "ms": call_ms(fn), "plain_ms": call_ms(plain_fn),
        "loop_ms": loop_ms(fn), "plain_loop_ms": loop_ms(plain_fn),
        "device_ms": device_ms(fn), "plain_device_ms": device_ms(plain_fn),
    }


def fmt_times(t: dict) -> str:
    return " ".join(f"{k}={v:.4f}" for k, v in t.items())


def allclose_excess(got, want, tol: float) -> float:
    """max(|got - want| - tol * |want|): <= tol means allclose(rtol=atol=tol)."""
    g, w = got.float(), want.float()
    return ((g - w).abs() - tol * w.abs()).max().item()


F32_RULE = 2.0  # an f32 kernel's error from float64 may be at most this x plain f32's


def cross_f64(x0, w, b, s=None):
    """The cross stack in float64; s [L, d]: the scales of int8 weights."""
    x0 = x0.double()
    x = x0
    for l in range(w.shape[0]):
        xw = x @ w[l].double()
        if s is not None:
            xw = xw * s[l].double()
        x = x0 * (xw + b[l].double()) + x
    return x


def serve_f64(ids, wts, sw):
    """The fused serve step's logits in float64 (float or int8 weights)."""
    import torch

    n = ids.shape[0]
    x0 = (sw.table[ids.long()].double() * wts.double()[..., None]).reshape(n, sw.d)
    h = x0
    for m, (w, b) in enumerate(sw.mlp):
        y = h @ w.double()
        if sw.ms is not None:
            y = y * sw.ms[m].double()
        h = torch.relu(y + b.double())
    xc = cross_f64(x0, sw.wc, sw.bc, sw.sc)
    return xc @ sw.wo[:sw.d].double() + h @ sw.wo[sw.d:].double() + sw.bo[0].double()


def f32_accuracy(what: str, kernel_fn, plain_fn, truth) -> dict:
    """Whether an f32 (split-TF32) kernel keeps f32 accuracy where an f32
    sum is itself far from the truth (unit-normal inputs, |x_L| up to ~25;
    on serving inputs every version sits far inside the parity tolerance):
    its max |error| from a float64 truth must be at most F32_RULE x the
    plain f32 version's (cuBLAS in full f32). The control, the plain
    version with TF32 matmuls (operands rounded to TF32, one product: what
    the split adds two products to), must miss the rule, or the rule could
    not tell the two apart."""
    import torch

    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    outs = {}
    try:
        for name, fn, tf32 in (("kernel", kernel_fn, False), ("plain", plain_fn, False),
                               ("tf32", plain_fn, True)):
            mm.allow_tf32 = tf32
            outs[name] = fn()
            torch.cuda.synchronize()
    finally:
        mm.allow_tf32 = prev
    err = {k: (v.double() - truth).abs().max().item() for k, v in outs.items()}
    log(f"kernels: {what} unit-normal inputs, max |d| from float64: kernel {err['kernel']:.3g}, "
        f"plain f32 {err['plain']:.3g}, plain TF32 {err['tf32']:.3g} (rule: kernel <= "
        f"{F32_RULE:g} x plain f32; TF32 must miss it)")
    if not err["kernel"] <= F32_RULE * err["plain"]:
        fail(f"{what}: on unit-normal inputs the kernel is {err['kernel']} from float64, over "
             f"{F32_RULE:g} x the plain f32 version's {err['plain']}")
    if err["tf32"] <= F32_RULE * err["plain"]:
        fail(f"{what}: the TF32 control ({err['tf32']} from float64) passes the f32 rule "
             f"(plain f32 {err['plain']}): the check cannot tell f32 from TF32")
    return {"unit_normal_err_vs_f64": err["kernel"], "unit_normal_plain_err_vs_f64": err["plain"],
            "unit_normal_tf32_err_vs_f64": err["tf32"]}


def serve_accuracy(ids, wts, sw, table) -> dict:
    """f32_accuracy of the fused serve logits on these ids and weights over
    a unit-normal embedding table."""
    import torch

    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck

    su = dataclasses.replace(sw, table=table)
    kname = "fused_serve_int8" if sw.quantized else "fused_serve"
    return f32_accuracy(f"{kname} float32 n={ids.shape[0]}",
                        lambda: ck.fused_serve(ids, wts, su)["logits"],
                        lambda: ck.fused_serve_reference(ids, wts, su)["logits"],
                        serve_f64(ids, wts.to(torch.float32), su))


def serve_cost(n: int, ids, sw, cd: str) -> tuple[float, float]:
    """(bytes, flops) the fused serve step needs for these inputs: each
    input read once (only the table rows these ids touch; weights at their
    own width, 1 byte for int8 plus the f32 scales), each output written
    once; matmul + elementwise operations (+ the scale multiplies)."""
    import torch

    d, D = sw.d, sw.embed_dim
    L = sw.wc.shape[0]
    rows = torch.unique(ids).numel()
    e = 2 if cd == "bfloat16" else 4
    nbytes = ids.numel() * 4 + ids.numel() * e + rows * D * 4
    nbytes += sw.wc.numel() * sw.wc.element_size() + sw.bc.numel() * 4
    flops = 2.0 * n * d * d * L + 3.0 * n * d * L
    if sw.quantized:
        nbytes += sw.sc.numel() * 4 + sum(s.numel() * 4 for s in sw.ms)
        flops += n * d * L + n * sum(w.shape[1] for w, _ in sw.mlp)
    for w, b in sw.mlp:
        nbytes += w.numel() * w.element_size() + b.numel() * 4
        flops += 2.0 * n * w.shape[0] * w.shape[1] + 2.0 * n * w.shape[1]
    nbytes += sw.wo.numel() * 4 + 4 + 2 * n * 4
    flops += 2.0 * n * sw.wo.numel() + n * (d + 4)
    return float(nbytes), flops


def cross_cost(n: int, d: int, L: int, cd: str) -> tuple[float, float]:
    e = 2 if cd == "bfloat16" else 4
    nbytes = n * d * e * 2 + L * d * d * e + L * d * 4
    flops = 2.0 * n * d * d * L + 3.0 * n * d * L
    return float(nbytes), flops


def bound(nbytes: float, flops: float, cd: str, int8_weights: bool = False) -> tuple[float, str]:
    """The least time for this work in ms, and what sets it. In f32 the
    operations' time is the lesser of the f32 FFMA bound (ops / 67 TFLOP/s)
    and the split-TF32 bound (3 x ops / 494.7 TFLOP/s, 2 x for int8
    weights): the latter, so a tensor-core kernel is never read as beating
    its bound."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[cd]
    if cd == "float32":
        t_ops = min(t_ops, SPLIT_TF32_PRODUCTS[int8_weights] * flops / TF32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(dev, registers: dict) -> dict:
    import torch

    from distributed_tf_serving_tpu_torch.models import ModelConfig, build_model
    from distributed_tf_serving_tpu_torch.models.embeddings import field_embed
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.ops.quantize import quantize_params

    rows = {"fused_serve": [], "fused_serve_int8": [], "fused_cross_apply": []}
    for cd in ("bfloat16", "float32"):
        cfg = ModelConfig(compute_dtype=cd)
        model = build_model("dcn_v2", cfg)
        params = model.init(SEED, dev)
        qparams = quantize_params(params)
        weights = {"fused_serve": (params, ck.build_fused_serve(params, cfg).serve_weights),
                   "fused_serve_int8": (qparams, ck.build_fused_serve(qparams, cfg).serve_weights)}
        for kname, (_, sw) in weights.items():
            cap = ck.serve_capacity(sw)
            log(f"kernels: {kname} {cd} clusters resident at once (cudaOccupancyMaxActive"
                f"Clusters, {ck.serve_smem_bytes(sw.d, [w.shape[1] for w, _ in sw.mlp], cfg.cdtype)}"
                f" B of shared memory per block): " + ", ".join(
                    f"C={c}: {k}" for c, k in zip(ck.CLUSTER_SIZES, cap))
                + f" (16 clusters of 8 fit one wave: {cap[3] >= 16})")
        wts_dtype = cfg.cdtype  # the transfer spec ships bf16 weights for bf16 models
        unit_table = torch.randn(params["embedding"].shape, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(SEED))
        for n in BUCKETS:
            g = torch.Generator(device="cpu").manual_seed(SEED + n)
            raw = torch.randint(0, 1 << 40, (n, cfg.num_fields), generator=g, dtype=torch.int64)
            ids = torch.remainder(raw, cfg.vocab_size).to(torch.int32).to(dev)
            wts_f32 = torch.rand((n, cfg.num_fields), generator=g).to(dev)
            wts = wts_f32.to(wts_dtype)
            app_float = None
            for kname, (tree, sw) in weights.items():
                # Held to model.apply on the same tree at 5e-3 in bf16, and
                # on the int8 tree in f32 too; f32 float weights are held to
                # the plain version alone (2e-5).
                app = model.apply(tree, {"feat_ids": raw.to(dev), "feat_wts": wts})
                app_float = app if kname == "fused_serve" else app_float
                gate_apply = cd == "bfloat16" or kname == "fused_serve_int8"
                ref = ck.fused_serve_reference(ids, wts, sw)

                def check(out, what):
                    err = (out["prediction_node"] - ref["prediction_node"]).abs().max().item()
                    err_apply = (out["prediction_node"] - app["prediction_node"]).abs().max().item()
                    if not torch.isfinite(out["logits"]).all():
                        fail(f"{what}: non-finite logits")
                    if err > SERVE_TOL[cd]:
                        fail(f"{what}: max |dscore| {err} > {SERVE_TOL[cd]}")
                    if gate_apply and err_apply > APPLY_TOL:
                        fail(f"{what}: max |dscore| vs model.apply {err_apply} > {APPLY_TOL}")
                    return err, err_apply

                out = ck.fused_serve(ids, wts, sw)
                torch.cuda.synchronize()
                err, err_apply = check(out, f"{kname} {cd} n={n}")
                t = timings(lambda: ck.fused_serve(ids, wts, sw),
                            lambda: ck.fused_serve_reference(ids, wts, sw))
                b_ms, b_by = bound(*serve_cost(n, ids, sw, cd), cd, sw.quantized)
                row = {"dtype": cd, "n": n, "max_abs_err": err, "tol": SERVE_TOL[cd],
                       "max_abs_err_vs_model_apply": err_apply}
                extra = ""
                if kname == "fused_serve_int8":
                    # Recorded, not gated: what the autotune's max_abs_delta reads.
                    row["dscore_vs_float_model_apply"] = (
                        out["prediction_node"] - app_float["prediction_node"]).abs().max().item()
                    extra = f" dscore_vs_float={row['dscore_vs_float_model_apply']:.3g}"
                row["cluster"] = ck.serve_cluster(n, ck.serve_capacity(sw))
                extra += f" cluster={row['cluster']}"
                row.update(t, bound_ms=b_ms, bound_by=b_by, **registers[KERNEL_NAMES[kname, cd]])
                if cd == "float32":
                    row.update(serve_accuracy(ids, wts, sw, unit_table))
                rows[kname].append(row)
                log(f"kernels: {kname} {cd} n={n} err={err:.3g} vs_apply={err_apply:.3g}{extra} "
                    f"{fmt_times(t)} bound_ms={b_ms:.5f} ({b_by})")
                base = ck.fused_serve(ids, wts, sw, _cluster=1)
                for c in CLUSTERS:
                    fn = lambda c=c: ck.fused_serve(ids, wts, sw, _cluster=c)  # noqa: E731
                    out = fn()
                    torch.cuda.synchronize()
                    what = f"{kname} {cd} n={n} forced cluster={c}"
                    err, err_apply = check(out, what)
                    same = all(torch.equal(out[k], base[k]) for k in ("logits", "prediction_node"))
                    if not same:
                        fail(f"{what}: not bit-identical to C = 1: max |dlogit| "
                             f"{(out['logits'] - base['logits']).abs().max().item()}")
                    tc = {"loop_ms": loop_ms(fn), "device_ms": device_ms(fn)}
                    rows[kname].append({"dtype": cd, "n": n, "cluster": c, "forced": True,
                                        "max_abs_err": err, "max_abs_err_vs_model_apply": err_apply,
                                        "bit_identical_to_c1": same, **tc})
                    log(f"kernels: {what} err={err:.3g} vs_apply={err_apply:.3g} "
                        f"bit-identical to C=1: {same} {fmt_times(tc)}")

            # The cross stack on what the main path hands it: model.apply's
            # compute-dtype x0 from the weighted field gather.
            sw = weights["fused_serve"][1]
            x0 = field_embed(params["embedding"], ids, wts, cfg.cdtype).reshape(n, sw.d)
            rows["fused_cross_apply"].extend(cross_rows(x0, sw.wc, sw.bc, cd, registers))
        del params, qparams, weights, model, unit_table
        torch.cuda.empty_cache()
    return rows


def warm_call_kernels(fn, calls: int = 20, attempts: int = 3) -> list[str]:
    """The names of the device kernels (and copies, fills) that `calls`
    warm calls of fn launch, from torch.profiler; the first profile that
    saw any device event (the tracer sometimes drops part of a window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    fail(f"torch.profiler recorded no device event in {attempts} profiles of {calls} calls")


def cross_rows(x0, w, b, cd: str, registers: dict) -> list[dict]:
    """The cross stack at one bucket: the rule's (R, C) held to the plain
    version and timed three ways, and in f32 held to a float64 truth on
    unit-normal x0 (f32_accuracy); every forced (R, C) too, each
    bit-identical to (16, 1) and allclose to the plain version, with
    `loop_ms` and `device_ms`. Fails if a warm call
    launches anything but the kernel (the weight operands are cached after
    the first call)."""
    import torch

    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck

    n = x0.shape[0]
    cdt = getattr(torch, cd)
    xr = ck.cross_stack_reference(x0, w, b, cdt)

    def check(xc, what) -> float:
        cerr = (xc.float() - xr.float()).abs().max().item()
        if not torch.isfinite(xc.float()).all() or allclose_excess(xc, xr, CROSS_TOL[cd]) > \
                CROSS_TOL[cd]:
            fail(f"{what}: max |d| {cerr} outside allclose rtol=atol={CROSS_TOL[cd]}")
        return cerr

    fn = lambda: ck.fused_cross_apply(x0, w, b, compute_dtype=cdt)  # noqa: E731
    cerr = check(fn(), f"fused_cross_apply {cd} n={n}")
    kernel = f"cross_stack_{'bf16' if cd == 'bfloat16' else 'f32'}_kernel"
    names = warm_call_kernels(fn)
    if not all(kernel in nm for nm in names) or len(names) > 20:
        fail(f"fused_cross_apply {cd} n={n}: 20 warm calls launched {len(names)} device "
             f"operations, not the kernel alone: {sorted(set(names))}")
    tc = timings(fn, lambda: ck.cross_stack_reference(x0, w, b, cdt))
    cb_ms, cb_by = bound(*cross_cost(n, x0.shape[1], w.shape[0], cd), cd)
    row = {"dtype": cd, "n": n, "max_abs_err": cerr, "tol": CROSS_TOL[cd], **tc,
           "bound_ms": cb_ms, "bound_by": cb_by, "warm_call_device_ops": len(names)}
    cap = ck.cross_capacity(ck.cached_cross_weights(w, b, cdt))
    if n == BUCKETS[0]:
        log(f"kernels: fused_cross_apply {cd} clusters resident at once (cudaOccupancy"
            f"MaxActiveClusters of the cross kernel, d={x0.shape[1]}): " + ", ".join(
                f"R={r} ({ck.cross_smem_bytes(x0.shape[1], cdt, r)} B) C={c}: {k}"
                for (r, c), k in cap.items()))
    row["rows_per_block"], row["cluster"] = ck.cross_plan(n, cap, x0.shape[1])
    row["capacity"] = {f"{r}x{c}": k for (r, c), k in cap.items()}
    row.update(registers[cross_kernel_name(cd, row["rows_per_block"])])
    if cd == "float32":
        xu = torch.randn(x0.shape, device=x0.device,
                         generator=torch.Generator(device=x0.device).manual_seed(SEED + n))
        row.update(f32_accuracy(f"fused_cross_apply float32 n={n}",
                                lambda: ck.fused_cross_apply(xu, w, b, compute_dtype=cdt),
                                lambda: ck.cross_stack_reference(xu, w, b, cdt),
                                cross_f64(xu, w, b)))
    log(f"kernels: fused_cross_apply {cd} n={n} err={cerr:.3g} plan=(R={row['rows_per_block']}, "
        f"C={row['cluster']}) {fmt_times(tc)} bound_ms={cb_ms:.5f} ({cb_by}); a warm call runs "
        "the kernel alone")
    out = [row]
    base = ck.fused_cross_apply(x0, w, b, compute_dtype=cdt, _plan=(16, 1))
    for plan in CROSS_PLANS:
        fp = lambda plan=plan: ck.fused_cross_apply(x0, w, b, compute_dtype=cdt,  # noqa: E731
                                                     _plan=plan)
        got = fp()
        torch.cuda.synchronize()
        what = f"fused_cross_apply {cd} n={n} forced (R, C)={plan}"
        err = check(got, what)
        if not torch.equal(got, base):
            fail(f"{what}: not bit-identical to (16, 1): max |d| "
                 f"{(got.float() - base.float()).abs().max().item()}")
        t = {"loop_ms": loop_ms(fp), "device_ms": device_ms(fp)}
        out.append({"dtype": cd, "n": n, "rows_per_block": plan[0], "cluster": plan[1],
                    "forced": True, "max_abs_err": err, "bit_identical_to_16_1": True, **t})
        log(f"kernels: {what} err={err:.3g} bit-identical {fmt_times(t)}")
    return out


def _request(ids, wts):
    from distributed_tf_serving_tpu_torch import codec
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

    req = apis.PredictRequest()
    req.model_spec.name = "DCN"
    req.model_spec.signature_name = "serving_default"
    codec.from_ndarray(ids, out=req.inputs["feat_ids"])
    codec.from_ndarray(wts, out=req.inputs["feat_wts"])
    req.output_filter.append("prediction_node")
    return req


STAGES = ("fused_pack", "h2d_unpack", "device_step", "d2h_issue", "d2h_wait",
          "perkey_fold_pack", "perkey_h2d_unpack", "perkey_d2h")


def breakdown(dev, batcher, servable) -> dict:
    """Median of 20 of each host/device stage of one batch at each bucket
    of configs/latency.toml (256, 512, 1024, 2048), through the batcher's own stage functions: on the serving
    path, the native pack into a pinned ring buffer (`fused_pack`), its one
    copy + unpack_device_combined (`h2d_unpack`), the device step, the
    readback issue (`d2h_issue`: non-blocking copies + event) and its wait
    (`d2h_wait`); beside them the per-key path (fold + pack_host, one
    pageable copy per input + unpack_device, `.cpu()`). Each stage is timed
    with the card idle before it (synchronized), so these are bare stage
    costs. The two paths' scores must be bit-identical."""
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch.ops.transfer import (
        pack_host,
        to_device,
        unpack_device,
        unpack_device_combined,
    )
    from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host

    entry = batcher.step_for(servable)
    cfg = servable.model.config
    out = {}
    for bucket in BUCKETS:
        step, params, _ = batcher._step(servable, entry, bucket, None)
        rng = np.random.RandomState(bucket)
        arrays = {"feat_ids": rng.randint(0, 1 << 40, size=(bucket, cfg.num_fields)).astype(np.int64),
                  "feat_wts": rng.rand(bucket, cfg.num_fields).astype(np.float32)}
        st = {k: [] for k in STAGES}
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctx = batcher._fused_ctx(servable, [arrays])
            if ctx is None:
                fail("breakdown: the fused_serve server's batch is not eligible for the native pack")
            buf, layout = batcher._pack(entry, ctx, bucket)
            t1 = time.perf_counter()
            dbuf, event = batcher._upload(buf)
            batch = unpack_device_combined(dbuf, layout)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            batcher.ring.release([buf], event)
            with torch.inference_mode():
                res = step(params, batch)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            rb = batcher._issue_readback({"prediction_node": res["prediction_node"]})
            t4 = time.perf_counter()
            host = batcher._wait(rb)["prediction_node"]
            t5 = time.perf_counter()
            packed = pack_host({"feat_ids": fold_ids_host(arrays["feat_ids"], cfg.vocab_size),
                                "feat_wts": arrays["feat_wts"]}, entry.spec)
            t6 = time.perf_counter()
            pbatch = unpack_device(to_device(packed, dev), entry.spec)
            torch.cuda.synchronize()
            t7 = time.perf_counter()
            with torch.inference_mode():
                pres = step(params, pbatch)
            torch.cuda.synchronize()
            t8 = time.perf_counter()
            phost = pres["prediction_node"].cpu().numpy()
            t9 = time.perf_counter()
            if not np.array_equal(host, phost):
                fail(f"breakdown bucket {bucket}: combined-path scores differ from the per-key "
                     f"path's (max |d| {np.max(np.abs(host - phost))})")
            for k, v in zip(STAGES, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t6 - t5,
                                     t7 - t6, t9 - t8)):
                st[k].append(v * 1e3)
        out[bucket] = {k: statistics.median(v) for k, v in st.items()}
        log(f"breakdown: bucket {bucket} " + " ".join(f"{k}={v:.4f}ms" for k, v in out[bucket].items()))
    return out


def submit_split(batcher, servable, payload, repeats: int = 20, max_wait_us=None) -> dict:
    """Where DynamicBatcher.submit time goes at n = len(payload), one
    request at a time, from the batcher's timeline: `submit` (submit() to
    enqueue), `collect` (enqueue to the group handed over, the coalescing
    window included), `staged` (waiting for the dispatch thread),
    `dispatch_stage` (pack, upload, step launch, readback issue),
    `readback_wait` (issue to outputs on the host), `completion_handoff`
    (outputs on the host to the caller's result() returning: slicing,
    set_result, the wake-up). Medians; their sum is near the p50.
    max_wait_us, when given, replaces the batcher's coalescing window for
    this run (0: `collect` is the batching thread's wake-up and assembly
    alone)."""
    ids, wts = payload
    wait0 = batcher.max_wait_s
    if max_wait_us is not None:
        batcher.max_wait_s = max_wait_us / 1e6
    batcher.timeline = []
    marks = []
    try:
        for _ in range(repeats):
            t0 = time.perf_counter()
            batcher.submit(servable, {"feat_ids": ids, "feat_wts": wts},
                           output_keys=("prediction_node",)).result(60)
            marks.append((t0, time.perf_counter()))
        timeline = batcher.timeline
    finally:
        batcher.timeline = None
        batcher.max_wait_s = wait0
    if len(timeline) != repeats:
        fail(f"submit split: {len(timeline)} timeline entries for {repeats} requests")
    parts = {k: [] for k in ("submit", "collect", "staged", "dispatch_stage", "readback_wait",
                             "completion_handoff")}
    lat = []
    for (t0, t1), (enq, col, stage, issue, ready, _) in zip(marks, timeline):
        for k, v in zip(parts, (enq - t0, col - enq, stage - col, issue - stage, ready - issue,
                                t1 - ready)):
            parts[k].append(v * 1e3)
        lat.append((t1 - t0) * 1e3)
    out = {"p50_ms": statistics.median(lat), "max_wait_us": round(wait0 * 1e6)
           if max_wait_us is None else max_wait_us,
           **{k: statistics.median(v) for k, v in parts.items()}}
    log(f"breakdown: n={len(ids)} through DynamicBatcher.submit (max_wait_us="
        f"{out['max_wait_us']}) p50={out['p50_ms']:.3f} ms = "
        + " + ".join(f"{k} {out[k]:.4f}" for k in parts) + " (medians, ms)")
    return out


def device_busy_us(prof) -> float:
    return sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages())


def closed_loop(port: int, payloads, per_client: int = 250) -> dict:
    """Closed-loop gRPC load: one client thread per payload, each sending
    `per_client` Predicts back to back on its own channel (the [client]
    point of configs/latency.toml: 1000 candidates, concurrency 4). p50 /
    p99 latency, QPS over the wall time, and the card's busy share over the
    same wall time from torch.profiler (device activity only)."""
    import threading

    import grpc
    from torch.profiler import ProfilerActivity, profile

    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto.service_grpc import LARGE_MESSAGE_CHANNEL_OPTIONS

    lat: list[list[float]] = [[] for _ in payloads]
    errors = []
    chans = [grpc.insecure_channel(f"127.0.0.1:{port}", options=LARGE_MESSAGE_CHANNEL_OPTIONS)
             for _ in payloads]
    barrier = threading.Barrier(len(payloads) + 1)

    def client(k):
        stub = PredictionServiceStub(chans[k])
        req = _request(*payloads[k])
        stub.Predict(req, timeout=60)  # channel up before the clock starts
        barrier.wait(timeout=120)
        try:
            for _ in range(per_client):
                t0 = time.perf_counter()
                stub.Predict(req, timeout=60)
                lat[k].append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(len(payloads))]
    try:
        for t in threads:
            t.start()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            barrier.wait(timeout=120)
            t0 = time.perf_counter()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
    finally:
        for ch in chans:
            ch.close()
    if errors or any(t.is_alive() for t in threads):
        fail(f"closed loop: client errors {errors[:3]}")
    flat = sorted(v for ls in lat for v in ls)
    return {"requests": len(flat), "clients": len(payloads), "wall_s": wall,
            "p50_ms": statistics.median(flat), "p99_ms": flat[int(0.99 * (len(flat) - 1))],
            "qps": len(flat) / wall, "device_busy_share": device_busy_us(prof) / (wall * 1e6)}


def host_path(dev, batcher, servable, stub, port, payload) -> dict:
    """After the counted run, on the bf16 fused_serve server: the stage
    breakdown, the n = 7 submit split, the gRPC floor and the card's busy
    share over 20 Predicts of n = 7, and the closed loop at pipeline_depth
    1 and 2."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {"stages_ms": breakdown(dev, batcher, servable),
           "submit_n7": submit_split(batcher, servable, payload),
           "submit_n7_no_window": submit_split(batcher, servable, payload, max_wait_us=0)}
    out["batcher_p50_ms"] = out["submit_n7"]["p50_ms"]
    if stub is None:
        return out
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        stub.GetModelMetadata(apis.GetModelMetadataRequest(model_spec=apis.ModelSpec(name="DCN")))
        lat.append((time.perf_counter() - t0) * 1e3)
    out["grpc_floor_p50_ms"] = statistics.median(lat)
    ids, wts = payload
    req = _request(ids, wts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(20):
            stub.Predict(req, timeout=60)
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = device_busy_us(prof)
    out["device_busy_share"] = busy_us / wall_us
    log(f"breakdown: gRPC floor (GetModelMetadata) p50={out['grpc_floor_p50_ms']:.3f} ms; "
        f"device busy {busy_us:.0f} us of {wall_us:.0f} us wall over 20 Predicts of "
        f"n={len(ids)} (idle share {1 - out['device_busy_share']:.3f})")
    cfg = servable.model.config
    rng = np.random.RandomState(SEED + 1000)
    loads = [(rng.randint(0, 1 << 40, size=(1000, cfg.num_fields)).astype(np.int64),
              rng.rand(1000, cfg.num_fields).astype(np.float32)) for _ in range(4)]
    depth0 = batcher.pipeline_depth
    out["closed_loop"] = {}
    try:
        for depth in (1, 2):
            batcher.pipeline_depth = depth
            s0 = dataclasses.replace(batcher.stats)
            r = closed_loop(port, loads)
            s1 = batcher.stats
            r["pipeline_depth"] = depth
            r["batches"] = s1.batches - s0.batches
            r["mean_requests_per_batch"] = (s1.requests - s0.requests) / max(r["batches"], 1)
            window = s1.readback_window_s - s0.readback_window_s
            r["readback_overlap_fraction"] = (
                1 - (s1.readback_blocked_s - s0.readback_blocked_s) / window if window > 0 else 0.0)
            out["closed_loop"][depth] = r
            log(f"closed loop: pipeline_depth={depth} {r['clients']} clients x "
                f"{r['requests'] // r['clients']} gRPC Predicts n=1000: p50={r['p50_ms']:.3f} ms "
                f"p99={r['p99_ms']:.3f} ms qps={r['qps']:.1f} busy share "
                f"{r['device_busy_share']:.3f} (idle {1 - r['device_busy_share']:.3f}), "
                f"{r['batches']} batches ({r['mean_requests_per_batch']:.2f} requests each), "
                f"readback overlap {r['readback_overlap_fraction']:.3f}")
    finally:
        batcher.pipeline_depth = depth0
    torch.cuda.synchronize()
    return out


def host_path_counts(label: str, servable, s0, s1, input_hits: int) -> dict:
    """The host path of one server's counted requests, from its BatcherStats
    before (s0) and after (s1) and the device input cache's hits in the
    same window: every batch one combined buffer and one host-to-device
    copy, or an input-cache hit (neither pack nor copy), so copies + hits
    = batches exactly; a bf16 server's every other batch packed natively;
    the readback overlapped (a completion worker, not the dispatch thread,
    waited for it)."""
    d = {k: getattr(s1, k) - getattr(s0, k) for k in (
        "batches", "requests", "native_packs", "h2d_copies",
        "readback_window_s", "readback_blocked_s")}
    d["input_cache_hits"] = input_hits
    window = d["readback_window_s"]
    d["readback_overlap_fraction"] = 1 - d["readback_blocked_s"] / window if window > 0 else 0.0
    bf16 = servable.model.config.compute_dtype == "bfloat16"
    want_native = d["batches"] - input_hits if bf16 else 0
    log(f"serving: {label} host path: {d['batches']} batches, {d['h2d_copies']} H2D copies, "
        f"{input_hits} input-cache hits, {d['native_packs']} native packs, readback overlap "
        f"{d['readback_overlap_fraction']:.3f}")
    if not d["batches"] or d["batches"] != d["h2d_copies"] + input_hits:
        fail(f"{label}: H2D copies + input-cache hits != batches: {d}")
    if d["native_packs"] != want_native:
        fail(f"{label}: {d['native_packs']} native packs for {d['batches']} batches "
             f"({'bf16' if bf16 else 'f32'}: want {want_native})")
    if not d["readback_overlap_fraction"] > 0:
        fail(f"{label}: the readback did not overlap (overlap fraction "
             f"{d['readback_overlap_fraction']})")
    return d


def combined_vs_per_key(label: str, batcher, servable, payloads) -> int:
    """Scores through the combined buffer (the serving path) must have the
    bits of the per-key path's on the same padded batch. Returns the number
    of batches compared."""
    import numpy as np

    from distributed_tf_serving_tpu_torch.serving.batcher import bucket_for

    for n, (ids, wts) in payloads.items():
        bucket = bucket_for(n, batcher.buckets)
        padded = {k: np.concatenate([v, np.zeros((bucket - n,) + v.shape[1:], v.dtype)])
                  for k, v in (("feat_ids", ids), ("feat_wts", wts))}
        a = batcher._execute(servable, padded, ("prediction_node",))["prediction_node"]
        b = batcher._execute(servable, padded, ("prediction_node",),
                             _per_key=True)["prediction_node"]
        if not np.array_equal(a, b):
            fail(f"{label} n={n}: combined-path scores differ from the per-key path's "
                 f"(max |d| {np.max(np.abs(a - b))})")
    log(f"serving: {label} combined path bit-identical to the per-key path at "
        f"n={sorted(payloads)}")
    return len(payloads)


def kernels_plane_config(suffix: str = ""):
    """configs/latency.toml with [kernels] armed (quantize and the fused
    kernel, the JAX package's default gates), its table in chiprun_out/
    (one per server: `suffix` names it)."""
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    table = os.path.join(out_dir, f"kernel_autotune{suffix}.json")
    if os.path.exists(table):
        os.remove(table)  # measure in this run, never adopt an older table
    with open(os.path.join(HERE, "configs", "latency.toml")) as f:
        text = f.read()
    path = os.path.join(out_dir, f"kernels_plane{suffix}.toml")
    with open(path, "w") as f:
        f.write(text + "\n[kernels]\nenabled = true\nquantize = true\npallas = true\n"
                f"table_file = {json.dumps(table)}\n")
    return load_config(path)["kernels"]


def check_autotune(table: dict, label: str) -> None:
    """Print the per-bucket autotune table; fail on an errored bucket or
    variant, or when the fused variants were not measured."""
    from distributed_tf_serving_tpu_torch.ops.autotune import BASELINE, VARIANTS

    if not table.get("pallas_eligible"):
        fail(f"{label}: fused variants ineligible: {table.get('pallas_ineligible_reason')}")
    for bucket, row in sorted(table["buckets"].items(), key=lambda kv: int(kv[0])):
        if "error" in row:
            fail(f"{label}: bucket {bucket} baseline failed: {row['error']}")
        parts = [f"{BASELINE} step_us={row[BASELINE]['step_us']}"]
        for v in VARIANTS:
            e = row.get(v)
            if e is None or "error" in e:
                fail(f"{label}: bucket {bucket} variant {v}: {e}")
            parts.append(f"{v} step_us={e['step_us']} speedup={e['speedup']} "
                         f"max_abs_delta={e['max_abs_delta']} enabled={e['enabled']}")
        log(f"autotune: {label} bucket {bucket}: " + "; ".join(parts) + f" -> {row['decision']}")


def phase_serving(dev, name: str, sizes=(7, 1000, 2048), repeats: int = 20) -> dict:
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch.models import build_model
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.ops.autotune import VARIANT_FLAGS
    from distributed_tf_serving_tpu_torch.serving.batcher import bucket_for
    from distributed_tf_serving_tpu_torch.serving.server import build_stack
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    loaded = load_config(os.path.join(HERE, "configs", "latency.toml"))
    cfg, model_cfg = loaded["server"], loaded["model"]
    try:
        import google.protobuf  # noqa: F401
        import grpc
        transport, missing = "grpc", None
        log(f"serving: grpc {grpc.__version__}, protobuf {google.protobuf.__version__}")
    except ImportError as e:
        transport, missing = "batcher", e.name
        log(f"serving: {missing} is not installed; driving DynamicBatcher.submit instead of gRPC")

    # (label, model config, fused serve kernel on?, [kernels] config): the
    # fused serve step, the use_pallas_cross configuration and the kernel
    # plane, whose autotune runs inside build_stack (before the counted run),
    # each in bf16 and in f32 (the AUC-parity mode).
    f32_cfg = dataclasses.replace(model_cfg, compute_dtype="float32")
    stacks = [
        ("fused_serve", model_cfg, True, None),
        ("cross_stack", dataclasses.replace(model_cfg, use_pallas_cross=True), False, None),
        ("kernels_plane", model_cfg, True, kernels_plane_config()),
        ("fused_serve_f32", f32_cfg, True, None),
        ("cross_stack_f32", dataclasses.replace(f32_cfg, use_pallas_cross=True), False, None),
        ("kernels_plane_f32", f32_cfg, True, kernels_plane_config("_f32")),
    ]
    built = []
    for label, mc, fused, kc in stacks:
        impl, batcher, servable = build_stack(cfg, mc, "cuda", seed=SEED, fused_kernel=fused,
                                              kernels_config=kc)
        if kc is not None:
            table = batcher.kernels.snapshot()["tables"][f"{servable.name}:{servable.version}"]
            check_autotune(table, label)
        server = port = None
        if transport == "grpc":
            from distributed_tf_serving_tpu_torch.serving.server import create_server

            server, port = create_server(impl, "127.0.0.1:0")
            server.start()
        built.append((label, impl, batcher, servable, server, port))

    rng = np.random.RandomState(SEED)
    payloads = {
        n: (rng.randint(0, 1 << 40, size=(n, model_cfg.num_fields)).astype(np.int64),
            rng.rand(n, model_cfg.num_fields).astype(np.float32))
        for n in sizes
    }
    results = {"transport": transport, "missing": missing, "card": name, "servers": {}}
    stubs, plain = {}, {}
    try:
        # The main path starts here: counters zeroed just before its requests.
        ck.reset_launches()
        builds0 = ck.cross_cache.builds
        for label, impl, batcher, servable, server, port in built:
            s0 = dataclasses.replace(batcher.stats)
            hits0 = batcher.input_cache.hits
            if server is not None:
                from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
                from distributed_tf_serving_tpu_torch.proto.service_grpc import (
                    LARGE_MESSAGE_CHANNEL_OPTIONS,
                )

                ch = grpc.insecure_channel(f"127.0.0.1:{port}", options=LARGE_MESSAGE_CHANNEL_OPTIONS)
                stubs[label] = (ch, PredictionServiceStub(ch))
            # The plain forward: model.apply with the cross-stack kernel off,
            # on the tree the kernel plane's decision picked for the bucket.
            plain[label] = build_model(
                servable.model.kind,
                dataclasses.replace(servable.model.config, use_pallas_cross=False),
            ).apply
            km = batcher.kernels
            per_size = {}
            for n, (ids, wts) in payloads.items():
                want_params, decision = servable.params, None
                if km is not None:
                    table = km.snapshot()["tables"][f"{servable.name}:{servable.version}"]
                    decision = table["buckets"][str(bucket_for(n, batcher.buckets))]["decision"]
                    want_params = km.params_for(servable, VARIANT_FLAGS[decision][0])
                lat = []
                got = None
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    if server is not None:
                        from distributed_tf_serving_tpu_torch import codec

                        resp = stubs[label][1].Predict(_request(ids, wts), timeout=120)
                        got = codec.to_ndarray(resp.outputs["prediction_node"])
                    else:
                        got = batcher.submit(
                            servable, {"feat_ids": ids, "feat_wts": wts},
                            output_keys=("prediction_node",),
                        ).result(120)["prediction_node"]
                    lat.append((time.perf_counter() - t0) * 1e3)
                with torch.inference_mode():
                    want = plain[label](
                        want_params,
                        {"feat_ids": torch.from_numpy(ids).to(dev),
                         "feat_wts": torch.from_numpy(wts).to(dev)},
                    )["prediction_node"].float().cpu().numpy()
                if got.shape != (n,) or not np.all(np.isfinite(got)):
                    fail(f"serving {label} n={n}: bad scores shape {got.shape}")
                err = float(np.max(np.abs(got - want)))
                tol = SERVE_TOL[servable.model.config.compute_dtype]
                if err > tol:
                    fail(f"serving {label} n={n}: max |dscore| vs plain forward {err} > {tol}")
                per_size[n] = {"p50_ms": statistics.median(lat), "max_abs_err": err,
                               "requests": len(lat), "decision": decision}
                log(f"serving: {label} n={n} p50={statistics.median(lat):.3f} ms "
                    f"err={err:.3g}" + (f" decision={decision}" if decision else "")
                    + f" ({transport}, {name})")
            results["servers"][label] = {
                "per_size": per_size,
                "batches": batcher.stats.batches,
                "fused_batches": batcher.stats.fused_batches,
                "host_path": host_path_counts(label, servable, s0, batcher.stats,
                                              batcher.input_cache.hits - hits0),
            }
            if km is not None:
                # The pallas_int8 entry live traffic uses, on the same
                # payloads padded to their buckets, whatever the decision.
                qparams = km.params_for(servable, True)
                for n, (ids, wts) in payloads.items():
                    bucket = bucket_for(n, batcher.buckets)
                    padded = {k: np.concatenate([v, np.zeros((bucket - n,) + v.shape[1:], v.dtype)])
                              for k, v in (("feat_ids", ids), ("feat_wts", wts))}
                    got = batcher._execute(servable, padded, ("prediction_node",),
                                           _kernel_override=(True, True))["prediction_node"][:n]
                    with torch.inference_mode():
                        want = plain[label](qparams, {
                            "feat_ids": torch.from_numpy(ids).to(dev),
                            "feat_wts": torch.from_numpy(wts).to(dev),
                        })["prediction_node"].float().cpu().numpy()
                    err = float(np.max(np.abs(got - want)))
                    tol = SERVE_TOL[servable.model.config.compute_dtype]
                    if not np.all(np.isfinite(got)) or err > tol:
                        fail(f"{label} pallas_int8 entry n={n}: max |dscore| vs model.apply "
                             f"on the int8 tree {err} > {tol}")
                    log(f"serving: {label} pallas_int8 entry n={n} (bucket {bucket}) "
                        f"err={err:.3g}")
                snap = km.snapshot()
                results["servers"][label]["autotune"] = snap["tables"]
                results["servers"][label]["counters"] = snap["counters"]
        results["launches"] = {f"{k}/{cd}": v for (k, cd), v in ck.launches.items()}
        # The use_pallas_cross servers' weight operands were prepared at
        # their warmup; their requests must reuse them.
        results["cross_weight_builds"] = ck.cross_cache.builds - builds0
        results["requests"] = len(built) * len(sizes) * repeats
        # After the counted run: the combined path against the per-key path,
        # then where a request's time goes (bf16 fused_serve server).
        results["bit_identity"] = {label: combined_vs_per_key(label, batcher, servable, payloads)
                                   for label, _, batcher, servable, _, _ in built}
        _, _, batcher, servable, server, port = built[0]
        results["breakdown"] = host_path(
            dev, batcher, servable, stubs["fused_serve"][1] if server is not None else None,
            port, payloads[min(sizes)],
        )
    finally:
        for ch, _ in stubs.values():
            ch.close()
        for label, impl, batcher, servable, server, port in built:
            if server is not None:
                server.stop(grace=1).wait()
            batcher.stop()
    for kname, cnt in results["launches"].items():
        if cnt <= 0:
            fail(f"the main path launched kernel {kname} no time (counts {results['launches']})")
    for kname in ("fused_serve/float32", "fused_cross_apply/float32"):
        if results["launches"][kname] < len(sizes) * repeats:
            fail(f"the f32 server did not launch {kname} for each request: "
                 f"{results['launches']}")
    if results["cross_weight_builds"]:
        fail(f"the cross_stack servers prepared cross weights {results['cross_weight_builds']} "
             "times during the main path; the cache should have held them since warmup")
    log(f"serving: launches during the main path {results['launches']} over "
        f"{results['requests']} requests ({len(sizes) * repeats} per server)")
    return results


LIFECYCLE_POLL_S = 0.25  # [server] file_system_poll_wait_seconds of the lifecycle server
LIFECYCLE_WARMUP_SIZES = (7, 1000, 2048)  # the Predict records of each version's warmup file
LIFECYCLE_TOL = APPLY_TOL  # every response against the plain forward of its version
LIFECYCLE_WINDOW = 400  # requests before the first swap, between swaps and after the last
LIFECYCLE_WAIT_S = 180.0  # bound on each wait of the phase
RETIRE_SETTLE_S = 10.0  # bound on the wait for a retired version's bytes to be freed


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_cli(args: list[str], log_path: str, ready_model: str = "DCN", env=None):
    """Start the port's CLI server (as tools/torch_closed_loop.py does) on a
    free port, in `env` (None: this process's); (process, port, log file)
    once it answers GetModelMetadata for `ready_model`."""
    return _await_cli(*_spawn_cli(args, log_path, env), args, log_path, ready_model)


def _spawn_cli(args: list[str], log_path: str, env=None):
    """The CLI server started on a free port, not waited for: (process,
    port, log file)."""
    port = _free_port()
    logf = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.serving.server", "--host", "127.0.0.1",
         "--port", str(port), *args],
        cwd=HERE, stdout=logf, stderr=subprocess.STDOUT, env=env)
    return proc, port, logf


def _await_cli(proc, port: int, logf, args: list[str], log_path: str,
               ready_model: str = "DCN"):
    """(process, port, log file) of a spawned server once it answers
    GetModelMetadata for `ready_model`; stopped, and the run failed, if it
    exits or does not answer in time."""
    import grpc

    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

    end = time.perf_counter() + LIFECYCLE_WAIT_S
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            stub = PredictionServiceStub(ch)
            while True:
                if proc.poll() is not None:
                    fail(f"server {args} exited with {proc.returncode} before it answered "
                         f"(log {log_path})")
                try:
                    stub.GetModelMetadata(apis.GetModelMetadataRequest(
                        model_spec=apis.ModelSpec(name=ready_model)), timeout=2)
                    return proc, port, logf
                except grpc.RpcError:
                    if time.perf_counter() > end:
                        fail(f"server {args} did not answer within {LIFECYCLE_WAIT_S} s")
                    time.sleep(0.2)
    except BaseException:
        _stop_cli(proc, logf)
        raise


def _stop_cli(proc, logf) -> int:
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    logf.close()
    return proc.returncode


def _server_log(path: str) -> dict:
    """What the lifecycle server logged: per version the load timings and
    the replayed warmup records, and the kernel launch counters at each
    version change and at shutdown."""
    import re

    out = {"loads": {}, "replayed": {}, "changes": [], "shutdown": None}
    with open(path) as f:
        for line in f:
            m = re.search(r"loaded DCN v(\d+) from \S+: (\{.*\})$", line)
            if m:
                out["loads"][int(m.group(1))] = json.loads(m.group(2))
            m = re.search(r"replayed (\d+) warmup records for DCN v(\d+)", line)
            if m:
                out["replayed"][int(m.group(2))] = int(m.group(1))
            m = re.search(r"kernel launches after a DCN version change: (\{.*\})$", line)
            if m:
                out["changes"].append(json.loads(m.group(1)))
            m = re.search(r"kernel launches at shutdown: (\{.*\})$", line)
            if m:
                out["shutdown"] = json.loads(m.group(1))
    return out


def _percentiles(lat: list[float]) -> dict:
    if not lat:
        return {"requests": 0}
    lat = sorted(lat)
    return {"requests": len(lat), "p50_ms": statistics.median(lat),
            "p99_ms": lat[int(0.99 * (len(lat) - 1))]}


def retire_memory(base, buckets, fused: bool, payload) -> dict:
    """Load version 1 of `base` through a VersionWatcher onto the card, serve
    one request, retire it: torch.cuda.memory_allocated before the load,
    while loaded and after the retire, and the cross-weight cache's
    entries then. The version dies on whichever thread drops its last
    batch (often a completion worker, `drain_s` after the retire), and
    that thread frees its tensors and cross-cache entry one by one, so
    `after_retire` is read once the count is back at `before_load` (or
    after `RETIRE_SETTLE_S`): `settle_s` after the version died. cuBLAS
    keeps a workspace per (handle, stream) that belongs to the thread
    that ran a matmul, not to any version, so both reads are taken with
    the workspaces cleared."""
    import gc
    import weakref

    import torch

    from distributed_tf_serving_tpu_torch.models import ServableRegistry
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher
    from distributed_tf_serving_tpu_torch.serving.version_watcher import (
        VersionWatcher,
        VersionWatcherConfig,
    )

    cached = []  # the device input cache's bytes at each read

    def allocated() -> int:
        gc.collect()
        torch.cuda.synchronize()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        # The device input cache belongs to the batcher, not to a version:
        # its entries stay resident, so their bytes are reported and the
        # cache is cleared before the read.
        cached.append(batcher.input_cache.nbytes())
        batcher.input_cache.clear()
        return torch.cuda.memory_allocated()

    batcher = DynamicBatcher(buckets=buckets, max_wait_us=0, device="cuda",
                             fused_kernel=fused).start()
    registry = ServableRegistry()
    w = VersionWatcher(base, registry, VersionWatcherConfig(poll_interval_s=3600),
                       warmup=batcher.warmup_via_queue, device=batcher.device)
    try:
        before = allocated()
        w.poll_once()
        if registry.models() != {"DCN": [1]}:
            fail(f"lifecycle memory: the watcher did not load {base}/1")
        batcher.submit(registry.resolve("DCN"), payload).result(60)
        torch.cuda.synchronize()
        loaded = torch.cuda.memory_allocated()
        ref = weakref.ref(registry.resolve("DCN"))
        table = weakref.ref(ref().params["embedding"])
        w.retire(1)
        t0 = time.perf_counter()
        while True:  # a thread may hold the last batch a moment longer
            gc.collect()
            if table() is None or time.perf_counter() - t0 > 10:
                break
            time.sleep(0.01)
        t1 = time.perf_counter()
        drain_s = t1 - t0
        while True:  # the thread that dropped it may still be freeing the rest
            after = allocated()
            if after <= before or time.perf_counter() - t1 > RETIRE_SETTLE_S:
                break
            time.sleep(0.005)
        return {"before_load": before, "loaded": loaded, "after_retire": after,
                "retained_bytes": after - before, "cross_cache_entries": len(ck.cross_cache),
                "input_cache_bytes_cleared": {"before_load": cached[0],
                                              "after_retire": max(cached[1:])},
                "servable_collected": ref() is None, "table_collected": table() is None,
                "drain_s": drain_s, "settle_s": time.perf_counter() - t1,
                "load_timings": w.load_timings.get(1)}
    finally:
        batcher.stop()


def phase_lifecycle(dev, name: str) -> dict:
    """The model lifecycle on the card: checkpoints written with the port's
    save_servable at the full width of configs/latency.toml into a
    temporary base path, the CLI server watching it (--model-base-path),
    4 client threads of unpinned Predicts (n = 1000) while v2 and then v3
    land, every response held to the plain forward of the version it
    names; then a --checkpoint server on v3, and in-process retire-memory
    checks."""
    import re
    import shutil
    import tempfile
    import threading

    import grpc
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch import codec
    from distributed_tf_serving_tpu_torch.models import Servable, build_model, ctr_signatures
    from distributed_tf_serving_tpu_torch.proto import ModelServiceStub, PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.proto.service_grpc import LARGE_MESSAGE_CHANNEL_OPTIONS
    from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host
    from distributed_tf_serving_tpu_torch.serving.warmup import (
        WARMUP_DIRNAME,
        WARMUP_FILENAME,
        make_warmup_record,
        write_tfrecords,
    )
    from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(HERE, "configs", "latency.toml")) as f:
        text = f.read()
    text, k = re.subn(r"(?m)^\[server\]\n",
                      f"[server]\nfile_system_poll_wait_seconds = {LIFECYCLE_POLL_S}\n", text)
    if k != 1:
        fail("configs/latency.toml has no [server] section")
    cfg_path = os.path.join(out_dir, "lifecycle.toml")
    with open(cfg_path, "w") as f:
        f.write(text)
    loaded = load_config(cfg_path)
    cfg, mc = loaded["server"], loaded["model"]
    F = mc.num_fields
    model = build_model("dcn_v2", mc)
    plain = build_model("dcn_v2", dataclasses.replace(model.config, use_pallas_cross=False))
    rng = np.random.RandomState(SEED + 2000)
    loads = [(rng.randint(0, 1 << 40, size=(1000, F)).astype(np.int64),
              rng.rand(1000, F).astype(np.float32)) for _ in range(4)]
    records = [make_warmup_record({
        "feat_ids": rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
        "feat_wts": rng.rand(n, F).astype(np.float32)}, "DCN") for n in LIFECYCLE_WARMUP_SIZES]

    # Each version's params (seed v - 1) and the plain forward of each
    # client payload on the card, before any clock starts.
    servables, want = {}, {}
    for v in (1, 2, 3):
        params = model.init(v - 1, "cpu")
        servables[v] = Servable(name="DCN", version=v, model=model, params=params,
                                signatures=ctr_signatures(F))
        on_card = {
            "embedding": params["embedding"].to(dev),
            "cross": [{k: t.to(dev) for k, t in p.items()} for p in params["cross"]],
            "mlp": [{k: t.to(dev) for k, t in p.items()} for p in params["mlp"]],
            "out": {k: t.to(dev) for k, t in params["out"].items()},
        }
        with torch.inference_mode():
            want[v] = [plain.apply(on_card, {
                "feat_ids": torch.from_numpy(fold_ids_host(ids, mc.vocab_size)).to(dev),
                "feat_wts": torch.from_numpy(wts).to(dev)})["prediction_node"].float().cpu().numpy()
                for ids, wts in loads]
        del on_card
    torch.cuda.empty_cache()

    base = tempfile.mkdtemp(prefix="dts_lifecycle_")
    manifest_at = {}  # version -> (perf_counter, time.time()) when its manifest was written

    def write(v: int) -> None:
        vdir = os.path.join(base, str(v))
        os.makedirs(os.path.join(vdir, WARMUP_DIRNAME))
        write_tfrecords(os.path.join(vdir, WARMUP_DIRNAME, WARMUP_FILENAME), records)
        save_servable(vdir, servables[v], "dcn_v2")  # params, then the manifest last
        manifest_at[v] = (time.perf_counter(), time.time())

    res = {"card": name, "poll_s": LIFECYCLE_POLL_S}
    procs = []
    try:
        write(1)
        t_start = time.perf_counter()
        proc, port, logf = _start_cli(["--config", cfg_path, "--model-base-path", base],
                                      os.path.join(out_dir, "lifecycle_server.log"))
        procs.append((proc, logf))
        res["server_start_s"] = time.perf_counter() - t_start

        lock = threading.Lock()
        rows: list[tuple[float, float, int]] = []  # (start, end, version)
        first = {}  # version -> perf_counter of its first response
        errs: dict[int, float] = {}
        last: dict[int, list] = {}
        failures: list = []
        stop = threading.Event()
        chans = [grpc.insecure_channel(f"127.0.0.1:{port}", options=LARGE_MESSAGE_CHANNEL_OPTIONS)
                 for _ in loads]

        def client(i: int) -> None:
            stub = PredictionServiceStub(chans[i])
            req = _request(*loads[i])
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    resp = stub.Predict(req, timeout=60)
                except Exception as e:  # noqa: BLE001 — every failure is counted
                    failures.append(repr(e))
                    continue
                t1 = time.perf_counter()
                v = resp.model_spec.version.value
                got = codec.to_ndarray(resp.outputs["prediction_node"])
                err = (float(np.max(np.abs(got - want[v][i])))
                       if v in want and got.shape == (1000,) and np.all(np.isfinite(got))
                       else float("inf"))
                with lock:
                    rows.append((t0, t1, v))
                    first.setdefault(v, t1)
                    errs[v] = max(errs.get(v, 0.0), err)
                    last.setdefault(v, [None] * len(loads))[i] = got

        def wait_for(what: str, cond) -> None:
            end = time.perf_counter() + LIFECYCLE_WAIT_S
            while True:
                with lock:
                    if cond():
                        return
                if failures or time.perf_counter() > end:
                    fail(f"lifecycle: {what} (failures {failures[:3]}, "
                         f"responses per version {sorted((v, sum(r[2] == v for r in rows)) for v in first)})")
                time.sleep(0.01)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(loads))]
        try:
            for t in threads:
                t.start()
            wait_for("no responses before the first swap", lambda: len(rows) >= LIFECYCLE_WINDOW)
            write(2)
            wait_for("v2 never answered", lambda: 2 in first)
            n2 = len(rows)
            wait_for("traffic stalled after v2", lambda: len(rows) >= n2 + LIFECYCLE_WINDOW)
            write(3)
            wait_for("v3 never answered", lambda: 3 in first)
            n3 = len(rows)
            wait_for("traffic stalled after v3", lambda: len(rows) >= n3 + LIFECYCLE_WINDOW)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)
            for ch in chans:
                ch.close()
        if any(t.is_alive() for t in threads):
            fail("lifecycle: a client thread did not stop")
        if failures:
            fail(f"lifecycle: {len(failures)} requests failed across the swaps: {failures[:3]}")
        for v, e in sorted(errs.items()):
            if v not in want or not e <= LIFECYCLE_TOL:
                fail(f"lifecycle: responses naming v{v} are {e} from its plain forward "
                     f"(> {LIFECYCLE_TOL})")

        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            status_stub = ModelServiceStub(ch)
            end = time.perf_counter() + 30
            while True:
                st = status_stub.GetModelStatus(apis.GetModelStatusRequest(
                    model_spec=apis.ModelSpec(name="DCN")), timeout=10)
                versions = [s.version for s in st.model_version_status]
                if versions == [2, 3] or time.perf_counter() > end:
                    break
                time.sleep(0.1)
        if versions != [2, 3]:
            fail(f"lifecycle: GetModelStatus ends at {versions}, want [2, 3] (v1 retired)")
        rc = _stop_cli(proc, logf)
        procs.clear()
        if rc != 0:
            fail(f"lifecycle: the base-path server exited with {rc}")
        slog = _server_log(os.path.join(out_dir, "lifecycle_server.log"))

        # Windows of the closed loop, by request start: before the first
        # manifest, across each swap (manifest written -> first response
        # from the new version), after it.
        m2, m3 = manifest_at[2][0], manifest_at[3][0]
        edges = [("before", -1e18, m2), ("across_v2", m2, first[2]), ("after_v2", first[2], m3),
                 ("across_v3", m3, first[3]), ("after_v3", first[3], 1e18)]
        res["closed_loop"] = {
            label: _percentiles([(e - s) * 1e3 for s, e, _ in rows if lo <= s < hi])
            for label, lo, hi in edges}
        res["responses_per_version"] = {v: sum(r[2] == v for r in rows) for v in sorted(first)}
        res["max_abs_err_per_version"] = errs
        res["status_versions"] = versions
        versions_out = {}
        for v in (1, 2, 3):
            t = dict(slog["loads"].get(v, {}))
            if slog["replayed"].get(v) != len(records) or t.get("replay_records") != len(records):
                fail(f"lifecycle: v{v} replayed {slog['replayed'].get(v)} warmup records, "
                     f"want {len(records)}")
            t["manifest_to_flip_s"] = t.get("loaded_at", float("nan")) - manifest_at[v][1]
            t["manifest_to_first_response_s"] = first[v] - manifest_at[v][0] if v in first else None
            versions_out[v] = t
        res["versions"] = versions_out
        changes, end_counts = slog["changes"], slog["shutdown"]
        if len(changes) < 4 or end_counts is None:
            fail(f"lifecycle: the server logged {len(changes)} version changes and "
                 f"{'no' if end_counts is None else 'its'} shutdown launch counters")
        key = "fused_serve/bfloat16"
        # changes: v1 loaded (startup), v2 loaded, v3 loaded, v1 retired.
        res["launches"] = {
            "path": {k: end_counts.get(k, 0) - changes[0].get(k, 0) for k in end_counts},
            "v1_live": changes[1].get(key, 0) - changes[0].get(key, 0),
            "v2_warmup_and_live": changes[2].get(key, 0) - changes[1].get(key, 0),
            "v3_after_flip": end_counts.get(key, 0) - changes[2].get(key, 0),
            "log": {"changes": changes, "shutdown": end_counts},
        }
        if res["launches"]["v3_after_flip"] <= 0 or res["launches"]["path"].get(key, 0) <= 0:
            fail(f"lifecycle: the hot-loaded versions did not launch {key}: {res['launches']}")
        for v, t in versions_out.items():
            log(f"lifecycle: v{v} read {t.get('read_s', float('nan')):.4f} s, H2D copy "
                f"{t.get('copy_s', float('nan')):.4f} s, bucket warmup "
                f"{t.get('warmup_s', float('nan')):.4f} s, replay of {t.get('replay_records')} "
                f"records {t.get('replay_s', float('nan')):.4f} s, manifest -> flip "
                f"{t['manifest_to_flip_s']:.3f} s, manifest -> first response "
                f"{t['manifest_to_first_response_s']:.3f} s"
                + (" (includes the server's start)" if v == 1 else "") + f" ({name})")
        for label, r in res["closed_loop"].items():
            log(f"lifecycle: closed loop {label}: " + (
                f"{r['requests']} requests p50={r['p50_ms']:.3f} ms p99={r['p99_ms']:.3f} ms"
                if r["requests"] else "no requests"))
        log(f"lifecycle: {sum(res['responses_per_version'].values())} responses "
            f"{res['responses_per_version']}, 0 failed, max |dscore| vs plain forward "
            f"{ {v: round(e, 6) for v, e in errs.items()} }, GetModelStatus {versions}; "
            f"{key} launches: v1 live {res['launches']['v1_live']}, v2 warmup+live "
            f"{res['launches']['v2_warmup_and_live']}, v3 after its flip "
            f"{res['launches']['v3_after_flip']}; path {res['launches']['path']}")

        # A --checkpoint server on v3 answers as the base-path server's v3.
        proc, port, logf = _start_cli(
            ["--config", cfg_path, "--checkpoint", os.path.join(base, "3")],
            os.path.join(out_dir, "lifecycle_checkpoint_server.log"))
        procs.append((proc, logf))
        ck_err, ck_vs_base = 0.0, 0.0
        with grpc.insecure_channel(f"127.0.0.1:{port}",
                                   options=LARGE_MESSAGE_CHANNEL_OPTIONS) as ch:
            stub = PredictionServiceStub(ch)
            for i, (ids, wts) in enumerate(loads):
                resp = stub.Predict(_request(ids, wts), timeout=60)
                got = codec.to_ndarray(resp.outputs["prediction_node"])
                if resp.model_spec.version.value != 3 or got.shape != (1000,) or \
                        not np.all(np.isfinite(got)):
                    fail(f"--checkpoint server: version {resp.model_spec.version.value}, "
                         f"shape {got.shape}")
                ck_err = max(ck_err, float(np.max(np.abs(got - want[3][i]))))
                if last.get(3, [None] * 4)[i] is not None:
                    ck_vs_base = max(ck_vs_base, float(np.max(np.abs(got - last[3][i]))))
        rc = _stop_cli(proc, logf)
        procs.clear()
        if rc != 0 or not ck_err <= LIFECYCLE_TOL:
            fail(f"--checkpoint server: rc {rc}, max |dscore| vs the plain forward of v3 {ck_err}")
        res["checkpoint_server"] = {"max_abs_err": ck_err, "max_abs_diff_vs_base_path_v3": ck_vs_base}
        log(f"lifecycle: --checkpoint v3 server max |dscore| vs plain forward {ck_err:.3g}, vs "
            f"the base-path server's v3 answers {ck_vs_base:.3g}")

        # In process: load and retire v1 through a VersionWatcher, on the
        # fused_serve stack and on the cross_stack stack (use_pallas_cross,
        # whose cross weights the cross cache prepares).
        cross_base = os.path.join(base, "cross")
        cross_model = build_model("dcn_v2", dataclasses.replace(mc, use_pallas_cross=True))
        save_servable(os.path.join(cross_base, "1"), dataclasses.replace(
            servables[1], model=cross_model), "dcn_v2")
        mem_base = os.path.join(base, "mem")
        os.makedirs(mem_base)
        os.symlink(os.path.join(base, "1"), os.path.join(mem_base, "1"))
        payload = {"feat_ids": loads[0][0], "feat_wts": loads[0][1]}
        res["memory"] = {
            "fused_serve": retire_memory(mem_base, cfg.buckets, True, payload),
            "cross_stack": retire_memory(cross_base, cfg.buckets, False, payload),
        }
        for label, m in res["memory"].items():
            log(f"lifecycle: memory {label}: allocated {m['before_load']} B before the load, "
                f"{m['loaded']} B loaded, {m['after_retire']} B after the retire "
                f"(retained {m['retained_bytes']} B; the version died {m['drain_s']:.3f} s "
                f"after the retire, its bytes were freed {m['settle_s']:.4f} s later; "
                f"cross cache {m['cross_cache_entries']} entries; device input cache "
                f"{m['input_cache_bytes_cleared']} B cleared before the reads; "
                f"read {m['load_timings'].get('read_s', float('nan')):.4f} s, "
                f"H2D {m['load_timings'].get('copy_s', float('nan')):.4f} s) ({name})")
            if not m["servable_collected"] or not m["table_collected"]:
                fail(f"lifecycle: {label}: the retired version is still alive (servable "
                     f"collected {m['servable_collected']}, table collected "
                     f"{m['table_collected']}) {m['drain_s']:.1f} s after its retire")
            if m["retained_bytes"] > (1 << 20):
                fail(f"lifecycle: {label} kept {m['retained_bytes']} B on the card after "
                     "its version was retired")
    finally:
        for proc, logf in procs:
            _stop_cli(proc, logf)
        shutil.rmtree(base, ignore_errors=True)
    return res


OUTPUT_SIZES = (7, 1000, 2048)  # requests of the outputs phase
OUTPUT_WIRES = ("float32", "bfloat16", "float16", "int8")
OUTPUT_TOP_K = 100
OUTPUT_REPEATS = 20
# |score - plain forward| allowed per wire on top of the serve tolerance:
# the wire's own rounding of a score in (0, 1) (bf16 8 bits, f16 11 bits
# of mantissa; int8 range/508, added per batch below).
WIRE_ROUNDING = {"none": 0.0, "float32": 0.0, "bfloat16": 2.0 ** -9, "float16": 2.0 ** -12,
                 "int8": 0.0}


def _q8_host(v):
    """The reference's int8 readback quantization on the host, in numpy:
    (q, scale, min), scale through the float32 reciprocal of 254 (the
    jitted JAX function's arithmetic)."""
    import numpy as np

    v = np.asarray(v, np.float32)
    mn = v.min()
    inv = np.float32(1.0) / np.float32(254.0)
    scale = np.maximum(np.float32(v.max() - mn) * inv, np.float32(1e-8))
    q = np.clip(np.rint((v - mn) / scale), np.float32(0), np.float32(254)) - np.float32(127)
    return q.astype(np.int8), np.float32(scale), np.float32(mn)


def d2h_times(batcher, servable, bucket: int, topk: int) -> dict:
    """Median of 20 of the readback wire at one bucket, through the
    batcher's own functions on one device-step output: `d2h_issue` (the
    wire transform's launches, the non-blocking copies, the event) and
    `d2h_wait` (the event, then the host restore), card idle before each
    issue; and the bytes the copies move against a float32 readback of
    every output. Then the issue must return while the card is still busy
    with a queued torch.cuda._sleep (~50 ms): the wire adds no host sync
    to the dispatch thread."""
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch.ops.transfer import unpack_device_combined

    entry = batcher.step_for(servable)
    step, params, _ = batcher._step(servable, entry, bucket, None)
    F = servable.model.config.num_fields
    rng = np.random.RandomState(bucket + 7)
    arrays = {"feat_ids": rng.randint(0, 1 << 40, size=(bucket, F)).astype(np.int64),
              "feat_wts": rng.rand(bucket, F).astype(np.float32)}
    buf, layout = batcher._pack(entry, batcher._fused_ctx(servable, [arrays]), bucket)
    dbuf, event = batcher._upload(buf)
    batcher.ring.release([buf], event)
    with torch.inference_mode():
        out = step(params, unpack_device_combined(dbuf, layout))

    def issue():
        t0 = time.perf_counter()
        with torch.inference_mode():
            rb = batcher._issue_readback(batcher._shape_outputs(
                servable, out, ("prediction_node",), topk, bucket))
        if topk:
            rb.topk = (bucket, "prediction_node")
        return rb, (time.perf_counter() - t0) * 1e3

    issue_ms, wait_ms = [], []
    for _ in range(OUTPUT_REPEATS):
        torch.cuda.synchronize()
        rb, ms = issue()
        t1 = time.perf_counter()
        batcher._wait(rb)
        issue_ms.append(ms)
        wait_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    rb, busy_ms = issue()
    still_busy = not torch.cuda.current_stream().query()
    batcher._wait(rb)
    if not still_busy:
        fail(f"outputs: the readback wire (top-k {topk}, {batcher.output_wire_dtype}) waited "
             f"for the card on the issue path ({busy_ms:.3f} ms behind a queued sleep)")
    return {"d2h_issue_ms": statistics.median(issue_ms), "d2h_wait_ms": statistics.median(wait_ms),
            "bytes": rb.nbytes, "full_f32_bytes": sum(v.numel() * 4 for v in out.values()),
            "issue_behind_busy_card_ms": busy_ms}


def phase_outputs(dev, name: str) -> dict:
    """The response path on the card, on the bf16 fused_serve configuration
    (configs/latency.toml, seed-0 weights): in-process batchers for each
    readback wire and for top-k, held to the no-wire batcher and to the
    plain forward, with the D2H issue / wait per wire and bucket; then a
    gRPC server with [kernels] (int8_score_wire), stream_chunk_candidates
    = 256 and a Unix-domain socket: the int8 score response wire,
    PredictStream at n = 2048 (chunks of 256 and 512), time to the first
    and the last chunk against unary Predict, and the GetModelMetadata
    floor over TCP and over the socket."""
    import shutil
    import tempfile

    import grpc
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch import codec
    from distributed_tf_serving_tpu_torch.models import ServableRegistry, build_model
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.ops.autotune import PALLAS_F32
    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.proto import tf_framework_pb2 as fw
    from distributed_tf_serving_tpu_torch.proto.service_grpc import LARGE_MESSAGE_CHANNEL_OPTIONS
    from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher, bucket_for
    from distributed_tf_serving_tpu_torch.serving.server import (
        build_stack,
        create_server,
        load_demo_servable,
    )
    from distributed_tf_serving_tpu_torch.utils.config import (
        BatchingConfig,
        KernelsConfig,
        load_config,
    )

    loaded = load_config(os.path.join(HERE, "configs", "latency.toml"))
    cfg, mc = loaded["server"], loaded["model"]
    F = mc.num_fields
    servable = load_demo_servable(ServableRegistry(), kind=cfg.model_kind, name=cfg.model_name,
                                  seed=SEED, config=mc, device=dev)
    plain = build_model(servable.model.kind,
                        dataclasses.replace(servable.model.config, use_pallas_cross=False)).apply
    rng = np.random.RandomState(SEED + 3000)
    payloads = {n: (rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
                    rng.rand(n, F).astype(np.float32)) for n in OUTPUT_SIZES}
    want = {}
    with torch.inference_mode():
        for n, (ids, wts) in payloads.items():
            want[n] = plain(servable.params, {"feat_ids": torch.from_numpy(ids).to(dev),
                                              "feat_wts": torch.from_numpy(wts).to(dev)}
                            )["prediction_node"].float().cpu().numpy()
    res = {"card": name}
    labels = ("none",) + OUTPUT_WIRES + ("topk",)
    batchers = {}
    try:
        for label in labels:
            kw = {}
            if label in OUTPUT_WIRES:
                kw["output_wire_dtype"] = label
            elif label == "topk":
                kw["output_top_k"] = OUTPUT_TOP_K
            b = DynamicBatcher(buckets=cfg.buckets, max_wait_us=0, device="cuda",
                               completion_workers=cfg.completion_workers,
                               pipeline_depth=cfg.pipeline_depth, **kw)
            b.warmup(servable)
            batchers[label] = b.start()
        if not all(b.step_for(servable).fused for b in batchers.values()):
            fail("outputs: a wire batcher does not serve through the fused serve kernel")

        # The phase's path, part 1: counters zeroed just before its
        # requests and read just after (the checks below, which launch the
        # kernel for reference results, are not counted).
        ck.reset_launches()
        stats0 = {k: dataclasses.replace(b.stats) for k, b in batchers.items()}
        got = {label: {} for label in labels}
        for n, (ids, wts) in payloads.items():
            for label, b in batchers.items():
                got[label][n] = b.submit(servable, {"feat_ids": ids, "feat_wts": wts},
                                         output_keys=("prediction_node",)
                                         ).result(120)["prediction_node"]
        res["batcher_launches"] = {f"{k}/{cd}": v for (k, cd), v in ck.launches.items()}
        checks = {}
        ref_b = batchers["none"]
        for n, (ids, wts) in payloads.items():
            ref = got["none"][n]
            bucket = bucket_for(n, ref_b.buckets)
            padded = {k: np.concatenate([v, np.zeros((bucket - n, F), v.dtype)])
                      for k, v in (("feat_ids", ids), ("feat_wts", wts))}
            full = ref_b._execute(servable, padded, ("prediction_node",))["prediction_node"]
            if not np.array_equal(full[:n], ref):
                fail(f"outputs n={n}: the no-wire batcher's live scores differ from its "
                     "_execute of the same padded batch")
            row = {}
            for label in labels:
                g = got[label][n]
                if g.shape != (n,) or g.dtype != np.float32:
                    fail(f"outputs {label} n={n}: result {g.dtype} {g.shape}")
                tol = SERVE_TOL["bfloat16"] + WIRE_ROUNDING.get(label, 0.0)
                if label == "float32":
                    exact = np.array_equal(g, ref)
                elif label in ("bfloat16", "float16"):
                    dt = torch.bfloat16 if label == "bfloat16" else torch.float16
                    exact = np.array_equal(g, torch.from_numpy(ref).to(dt).float().numpy())
                elif label == "int8":
                    q, scale, mn = _q8_host(full)
                    tol += float(full.max() - full.min()) / 508
                    exact = np.array_equal(g, codec.dequantize_scores(q, scale, mn)[:n])
                    wb = batchers["int8"]
                    rb = wb._issue(servable, padded, bucket, ("prediction_node",))
                    if rb.event is not None:
                        rb.event.synchronize()
                    raw = {k: view.clone() for k, (_, view) in rb.out.items()}
                    restored = wb._wait(rb)["prediction_node"]
                    exact = exact and np.array_equal(raw["prediction_node"].numpy(), q) and \
                        raw["prediction_node::q8scale"].numpy()[0] == scale and \
                        raw["prediction_node::q8min"].numpy()[0] == mn and \
                        np.array_equal(restored, codec.dequantize_scores(q, scale, mn))
                elif label == "topk":
                    if n > OUTPUT_TOP_K:
                        top = np.argsort(-ref, kind="stable")[:OUTPUT_TOP_K]
                        head = np.zeros(n, bool)
                        head[top] = True
                        exact = np.array_equal(np.flatnonzero(g), np.sort(top)) and \
                            np.array_equal(g[top], ref[top]) and np.all(g[~head] == 0)
                        g = np.where(head, g, want[n])  # the tail is unranked: not compared
                    else:  # k >= n: the full vector
                        exact = np.array_equal(g, ref)
                else:
                    exact = True
                err = float(np.max(np.abs(g - want[n])))
                if not exact:
                    fail(f"outputs {label} n={n}: not the exact wire result of the no-wire "
                         "batcher's scores")
                if not np.all(np.isfinite(g)) or err > tol:
                    fail(f"outputs {label} n={n}: max |dscore| vs plain forward {err} > {tol}")
                row[label] = {"max_abs_err": err, "tol": tol}
            checks[n] = row
            log(f"outputs: n={n} (bucket {bucket}) exact wire results; max |dscore| vs plain "
                "forward " + " ".join(f"{k}={v['max_abs_err']:.3g}" for k, v in row.items()))
        res["checks"] = checks
        res["wire_counts"] = {}
        for label, b in batchers.items():
            s0, s1 = stats0[label], b.stats
            d = {k: getattr(s1, k) - getattr(s0, k) for k in (
                "batches", "topk_batches", "bytes_downloaded", "bytes_download_full_f32")}
            res["wire_counts"][label] = d
            if d["batches"] != len(OUTPUT_SIZES):
                fail(f"outputs {label}: {d['batches']} batches for {len(OUTPUT_SIZES)} requests")
        tk = res["wire_counts"]["topk"]
        n_topk = sum(n > OUTPUT_TOP_K for n in OUTPUT_SIZES)
        if tk["topk_batches"] != n_topk:
            fail(f"outputs: {tk['topk_batches']} top-k batches, want {n_topk}")
        topk_bytes = 8 * OUTPUT_TOP_K * n_topk + 4 * bucket_for(min(OUTPUT_SIZES), cfg.buckets)
        if tk["bytes_downloaded"] != topk_bytes:
            fail(f"outputs: top-k batches read back {tk['bytes_downloaded']} B, want "
                 f"{8 * OUTPUT_TOP_K} per top-k batch ({topk_bytes} with the n=7 batch)")
        log(f"outputs: top-k {OUTPUT_TOP_K}: {tk['topk_batches']} batches read back "
            f"{8 * OUTPUT_TOP_K} B each (the n={min(OUTPUT_SIZES)} batch, k >= n, reads back "
            "its vector)")

        # D2H per wire and bucket (outside the counted requests).
        d2h = {}
        for label, b in batchers.items():
            d2h[label] = {}
            for bucket in cfg.buckets:
                t = d2h_times(b, servable, bucket, OUTPUT_TOP_K if label == "topk" else 0)
                d2h[label][bucket] = t
                log(f"outputs: d2h {label} bucket {bucket}: issue {t['d2h_issue_ms']:.4f} ms, "
                    f"wait {t['d2h_wait_ms']:.4f} ms, {t['bytes']} B read back of "
                    f"{t['full_f32_bytes']} B full f32; issue behind a busy card "
                    f"{t['issue_behind_busy_card_ms']:.4f} ms, returned before it ({name})")
        res["d2h"] = d2h
    finally:
        for b in batchers.values():
            b.stop()

    # The gRPC server: [kernels] (float variants only, so each bucket serves
    # the fused kernel or model.apply on the float weights) with the int8
    # score wire, PredictStream chunks of 256, and a Unix-domain socket.
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    table = os.path.join(out_dir, "kernel_autotune_outputs.json")
    if os.path.exists(table):
        os.remove(table)
    kcfg = KernelsConfig(enabled=True, quantize=False, pallas=True, int8_score_wire=True,
                         table_file=table)
    impl, batcher, sv = build_stack(cfg, mc, "cuda", seed=SEED, kernels_config=kcfg,
                                    batching_config=BatchingConfig(stream_chunk_candidates=256))
    if not impl.int8_score_wire or impl.stream_chunk_candidates != 256:
        fail("outputs: build_stack did not arm the int8 score wire / the stream chunk")
    table = batcher.kernels.snapshot()["tables"][f"{sv.name}:{sv.version}"]
    if not table.get("pallas_eligible"):
        fail(f"outputs server: fused variants ineligible: {table.get('pallas_ineligible_reason')}")
    for bucket, row in table["buckets"].items():
        if "error" in row or "error" in row.get(PALLAS_F32, {"error": "not measured"}):
            fail(f"outputs server: bucket {bucket} autotune row {row}")
    res["server_decisions"] = {int(b): row["decision"] for b, row in table["buckets"].items()}
    log(f"outputs: server autotune decisions (float variants) {res['server_decisions']}")
    sock_dir = tempfile.mkdtemp(prefix="dts_uds_")
    uds = os.path.join(sock_dir, "dts.sock")
    server, port = create_server(impl, "127.0.0.1:0", uds_path=uds)
    server.start()
    chans = []
    try:
        tcp = grpc.insecure_channel(f"127.0.0.1:{port}", options=LARGE_MESSAGE_CHANNEL_OPTIONS)
        unix = grpc.insecure_channel(f"unix:{uds}", options=LARGE_MESSAGE_CHANNEL_OPTIONS)
        chans += [tcp, unix]
        stub, ustub = PredictionServiceStub(tcp), PredictionServiceStub(unix)
        n = max(OUTPUT_SIZES)
        ids, wts = payloads[n]
        req = _request(ids, wts)
        # Part 2: the server's requests, counted from here to their end.
        s0 = dataclasses.replace(batcher.stats)
        launches0 = dict(ck.launches)
        # int8 score response wire.
        q_resp = stub.Predict(req, timeout=120, metadata=(("x-dts-score-wire", "int8"),))
        f_resp = stub.Predict(req, timeout=120)
        if q_resp.outputs["prediction_node"].dtype != fw.DataType.DT_INT8 or sorted(
                q_resp.outputs) != ["prediction_node", "prediction_node/q8_min",
                                    "prediction_node/q8_scale"]:
            fail(f"outputs: the int8 score wire answered {sorted(q_resp.outputs)} "
                 f"({fw.DataType.Name(q_resp.outputs['prediction_node'].dtype)})")
        fscores = codec.to_ndarray(f_resp.outputs["prediction_node"])
        qscores = codec.dequantize_response_output(q_resp.outputs, "prediction_node")
        spread = float(fscores.max() - fscores.min())
        q_err = float(np.max(np.abs(qscores - fscores)))
        if f_resp.outputs["prediction_node"].dtype != fw.DataType.DT_FLOAT or \
                q_err > spread / 508 * 1.001 + 1e-7:
            fail(f"outputs: the int8 score wire is {q_err} from the float response "
                 f"(range/508 = {spread / 508})")
        f_err = float(np.max(np.abs(fscores - want[n])))
        if f_err > SERVE_TOL["bfloat16"]:
            fail(f"outputs: the server's float response is {f_err} from the plain forward")
        res["int8_response"] = {"max_abs_err_vs_float": q_err, "range_over_508": spread / 508,
                                "bytes_int8": q_resp.ByteSize(), "bytes_f32": f_resp.ByteSize()}
        log(f"outputs: int8 score wire n={n}: DT_INT8 + both sidecars, max |d| vs the float "
            f"response {q_err:.3g} (range/508 {spread / 508:.3g}); response {q_resp.ByteSize()} "
            f"B against {f_resp.ByteSize()} B")

        # PredictStream at n = 2048: the server's 256 and the 512 override.
        stream = {}
        for chunk, md in ((256, None), (512, (("x-dts-stream-chunk", "512"),))):
            first, last = [], []
            for _ in range(OUTPUT_REPEATS):
                t0 = time.perf_counter()
                merged = np.full(n, np.nan, np.float32)
                seen = np.zeros(n, np.int32)
                finals = 0
                t_first = None
                for c in stub.PredictStream(req, timeout=120, metadata=md):
                    if t_first is None:
                        t_first = time.perf_counter()
                    part = codec.to_ndarray(c.outputs["prediction_node"])
                    if c.total != n or part.shape != (c.count,) or c.count > chunk:
                        fail(f"outputs: stream chunk offset {c.offset} count {c.count} total "
                             f"{c.total} (chunk {chunk})")
                    merged[c.offset:c.offset + c.count] = part
                    seen[c.offset:c.offset + c.count] += 1
                    finals += bool(c.final)
                t_last = time.perf_counter()
                if finals != 1 or not np.all(seen == 1):
                    fail(f"outputs: PredictStream chunk {chunk}: {finals} final chunks, rows "
                         f"covered {np.unique(seen)} times")
                first.append((t_first - t0) * 1e3)
                last.append((t_last - t0) * 1e3)
            err = float(np.max(np.abs(merged - want[n])))
            if not np.all(np.isfinite(merged)) or err > SERVE_TOL["bfloat16"]:
                fail(f"outputs: PredictStream chunk {chunk}: max |dscore| vs plain forward {err}")
            stream[chunk] = {"first_chunk_p50_ms": statistics.median(first),
                             "last_chunk_p50_ms": statistics.median(last), "max_abs_err": err,
                             "chunks": -(-n // chunk)}
        unary = []
        for _ in range(OUTPUT_REPEATS):
            t0 = time.perf_counter()
            stub.Predict(req, timeout=120)
            unary.append((time.perf_counter() - t0) * 1e3)
        res["stream"] = stream
        res["unary_p50_ms"] = statistics.median(unary)
        for chunk, r in stream.items():
            log(f"outputs: PredictStream n={n} chunks of {chunk} ({r['chunks']}): first chunk "
                f"p50 {r['first_chunk_p50_ms']:.3f} ms, last chunk p50 "
                f"{r['last_chunk_p50_ms']:.3f} ms, against unary Predict p50 "
                f"{res['unary_p50_ms']:.3f} ms; max |dscore| vs plain forward "
                f"{r['max_abs_err']:.3g} ({name})")

        # The transport floor over TCP and over the socket.
        floors = {}
        for label, st in (("tcp", stub), ("uds", ustub)):
            st.GetModelMetadata(apis.GetModelMetadataRequest(
                model_spec=apis.ModelSpec(name="DCN")), timeout=60)
            lat = []
            for _ in range(OUTPUT_REPEATS):
                t0 = time.perf_counter()
                st.GetModelMetadata(apis.GetModelMetadataRequest(
                    model_spec=apis.ModelSpec(name="DCN")), timeout=60)
                lat.append((time.perf_counter() - t0) * 1e3)
            floors[label] = statistics.median(lat)
        uds_scores = codec.to_ndarray(ustub.Predict(req, timeout=120).outputs["prediction_node"])
        if not np.array_equal(uds_scores, fscores):
            fail("outputs: Predict over the Unix-domain socket differs from TCP")
        res["floor_p50_ms"] = floors
        log(f"outputs: GetModelMetadata floor p50 TCP {floors['tcp']:.3f} ms, UDS "
            f"{floors['uds']:.3f} ms ({name})")
        res["server_batches"] = batcher.stats.batches - s0.batches
        res["server_launches"] = {f"{k}/{cd}": v - launches0.get((k, cd), 0)
                                  for (k, cd), v in ck.launches.items()}
    finally:
        for ch in chans:
            ch.close()
        server.stop(grace=1).wait()
        batcher.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    res["launches"] = {k: v + res["server_launches"][k] for k, v in res["batcher_launches"].items()}
    if res["launches"]["fused_serve/bfloat16"] <= 0:
        fail(f"outputs: the phase launched fused_serve/bfloat16 no time ({res['launches']})")
    log(f"outputs: launches on the phase's path {res['launches']} (batchers "
        f"{res['batcher_launches']['fused_serve/bfloat16']}, server "
        f"{res['server_launches']['fused_serve/bfloat16']} over {res['server_batches']} "
        "batches)")
    return res


# The families phase: BASELINE.json's candidate count per family (generic:
# the [client] candidate_num of configs/latency.toml), in this order.
FAMILY_SIZES = {"wide_deep": 128, "deepfm": 512, "generic": 1000, "dlrm": 4096,
                "two_tower": 10_000}
FAMILY_BUCKETS = (128, 512, 1024, 2048, 4096, 16384)
FAMILY_REPEATS = 20
FAMILY_TOL = 1e-5  # the batcher's scores against the card's direct model.apply
FAMILY_CPU_TOL = 2e-5  # the card's f32 forward against the CPU's
FAMILY_TOP_K = 100  # two_tower's retrieval head
# The autotune's reason for leaving the fused variants out, per family (the
# JAX package's reasons, in its order of checks).
FAMILY_FUSED_REASON = {"dlrm": "inputs beyond feat_ids/feat_wts"}
NOT_DCN_V2 = "param tree is not dcn_v2-shaped"


def _family_arrays(kind: str, n: int, fields: int, dense: int, seed: int) -> dict:
    import numpy as np

    rng = np.random.RandomState(seed)
    arrays = {"feat_ids": rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
              "feat_wts": rng.rand(n, fields).astype(np.float32)}
    if kind == "dlrm":
        arrays["dense_features"] = rng.randn(n, dense).astype(np.float32)
    return arrays


def _family_request(name: str, arrays: dict):
    from distributed_tf_serving_tpu_torch import codec
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

    req = apis.PredictRequest()
    req.model_spec.name = name
    req.model_spec.signature_name = "serving_default"
    for k, v in arrays.items():
        codec.from_ndarray(v, out=req.inputs[k])
    req.output_filter.append("prediction_node")
    return req


def kernels_per_call(fn, iters: int = 10) -> float:
    """Device kernels (and copies, memsets) one call runs — the eager
    forward's launches — from a torch.profiler trace of `iters` calls: the
    events with device time (the trace's CUDA activity also holds the
    host-side runtime calls, which have none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
               > 0) / iters


def phase_families(dev, name: str) -> dict:
    """The other model families (models/wide_deep, deepfm, generic, dlrm,
    two_tower) at the full width of configs/latency.toml [model] (43 fields
    x 16, vocab 2^20, MLP 256/128/64; DLRM 13 dense features, bottom MLP
    64/32/16; two_tower 8 user fields), seed-0 weights, on the bucket ladder
    FAMILY_BUCKETS. Per family and compute dtype, build_stack (model_kind =
    the family) serves its BASELINE.json size through DynamicBatcher.submit:
    the scores must be within 1e-5 of the card's model.apply on the same
    padded batch, and in f32 within 2e-5 of the CPU's forward of the same
    params. The eager device step is timed (one call with CUDA events, the
    profiler's device time, kernels per call). The bf16 stack arms
    [kernels] (JAX default gates): its autotune table (xla_int8 measured,
    the fused variants ineligible with the JAX reason), then 20 gRPC
    Predicts at the family's size: p50 and the card's busy share. two_tower
    at 10 000 with output_top_k = 100 must return the head of a stable
    descending sort of its full scores. Neither CUDA kernel may launch in
    the phase: they serve dcn_v2 alone."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import grpc

    from distributed_tf_serving_tpu_torch import codec
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.ops.autotune import BASELINE, VARIANT_FLAGS
    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto.service_grpc import LARGE_MESSAGE_CHANNEL_OPTIONS
    from distributed_tf_serving_tpu_torch.serving.batcher import bucket_for
    from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server
    from distributed_tf_serving_tpu_torch.train.checkpoint import flatten_params, unflatten_like
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    loaded = load_config(os.path.join(HERE, "configs", "latency.toml"))
    cfg = dataclasses.replace(loaded["server"], buckets=FAMILY_BUCKETS)
    model_cfg = loaded["model"]
    kc = kernels_plane_config("_families")
    res = {"card": name, "families": {}}
    # The phase's path: counters zeroed just before it, read just after.
    ck.reset_launches()
    for i, (kind, n) in enumerate(FAMILY_SIZES.items()):
        arrays = _family_arrays(kind, n, model_cfg.num_fields, model_cfg.num_dense_features,
                                SEED + 100 + i)
        fam = res["families"][kind] = {"n": n}
        for cd in ("bfloat16", "float32"):
            mc = dataclasses.replace(model_cfg, compute_dtype=cd)
            scfg = dataclasses.replace(cfg, model_kind=kind, model_name=kind)
            t0 = time.perf_counter()
            impl, batcher, sv = build_stack(scfg, mc, "cuda", seed=SEED,
                                            kernels_config=kc if cd == "bfloat16" else None)
            out = fam[cd] = {"build_s": time.perf_counter() - t0}
            server = None
            try:
                if sv.model.kind != kind:
                    fail(f"families: build_stack served kind {sv.model.kind!r} for {kind!r}")
                bucket = bucket_for(n, batcher.buckets)
                km = batcher.kernels
                decision = BASELINE
                if km is not None:
                    table = km.snapshot()["tables"][f"{sv.name}:{sv.version}"]
                    decision = table["buckets"][str(bucket)]["decision"]
                params = (km.params_for(sv, VARIANT_FLAGS[decision][0]) if km is not None
                          else sv.params)
                padded = {k: torch.from_numpy(np.concatenate(
                    [v, np.zeros((bucket - n,) + v.shape[1:], v.dtype)])).to(dev)
                    for k, v in arrays.items()}

                def step():
                    with torch.inference_mode():
                        return sv.model.apply(params, padded)

                direct = step()["prediction_node"].float().cpu().numpy()[:n]
                got = batcher.submit(sv, arrays, output_keys=("prediction_node",)
                                     ).result(120)["prediction_node"]
                if got.shape != (n,) or not np.all(np.isfinite(got)):
                    fail(f"families: {kind} {cd} n={n}: bad scores shape {got.shape}")
                err = float(np.max(np.abs(got - direct)))
                if err > FAMILY_TOL:
                    fail(f"families: {kind} {cd} n={n}: batcher vs the card's model.apply "
                         f"max |d| {err} > {FAMILY_TOL}")
                out.update(bucket=bucket, decision=decision, batcher_vs_direct=err,
                           step_ms=call_ms(step, iters=20), step_device_ms=device_ms(step),
                           kernels_per_step=kernels_per_call(step))
                if cd == "float32":
                    cpu_params = unflatten_like(params, {
                        k: v.cpu() for k, v in flatten_params(params).items()})
                    with torch.inference_mode():
                        cpu = sv.model.apply(cpu_params, {k: torch.from_numpy(v)
                                                          for k, v in arrays.items()})
                    cerr = float(np.max(np.abs(got - cpu["prediction_node"].numpy())))
                    out["card_vs_cpu"] = cerr
                    if cerr > FAMILY_CPU_TOL:
                        fail(f"families: {kind} f32 n={n}: card vs CPU forward max |d| "
                             f"{cerr} > {FAMILY_CPU_TOL}")
                log(f"families: {kind} {cd} n={n} (bucket {bucket}, {decision}): batcher vs "
                    f"direct {err:.3g}" + (f", card vs CPU {out['card_vs_cpu']:.3g}"
                                           if "card_vs_cpu" in out else "")
                    + f"; device step {out['step_ms']:.4f} ms one call, "
                    f"{out['step_device_ms']:.4f} ms device, "
                    f"{out['kernels_per_step']:.0f} kernels ({name})")
                if km is None:
                    continue
                out["autotune"] = table
                check_family_autotune(table, kind)
                server, port = create_server(impl, "127.0.0.1:0")
                server.start()
                ch = grpc.insecure_channel(f"127.0.0.1:{port}",
                                           options=LARGE_MESSAGE_CHANNEL_OPTIONS)
                try:
                    stub = PredictionServiceStub(ch)
                    req = _family_request(sv.name, arrays)
                    stub.Predict(req, timeout=120)  # channel up before the clock
                    lat = []
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        for _ in range(FAMILY_REPEATS):
                            t1 = time.perf_counter()
                            resp = stub.Predict(req, timeout=120)
                            lat.append((time.perf_counter() - t1) * 1e3)
                            scores = codec.to_ndarray(resp.outputs["prediction_node"])
                            gerr = float(np.max(np.abs(scores - direct)))
                            if scores.shape != (n,) or gerr > FAMILY_TOL:
                                fail(f"families: {kind} gRPC n={n}: max |d| vs the card's "
                                     f"model.apply {gerr} > {FAMILY_TOL}")
                        wall_us = (time.perf_counter() - t0) * 1e6
                finally:
                    ch.close()
                out["grpc_p50_ms"] = statistics.median(lat)
                out["device_busy_share"] = device_busy_us(prof) / wall_us
                log(f"families: {kind} bf16 gRPC n={n}: p50 {out['grpc_p50_ms']:.3f} ms over "
                    f"{FAMILY_REPEATS} Predicts, busy share {out['device_busy_share']:.4f} "
                    f"({name})")
                if kind == "two_tower":
                    fam["top_k"] = two_tower_top_k(dev, batcher, sv, arrays, got)
            finally:
                if server is not None:
                    server.stop(grace=1).wait()
                batcher.stop()
    res["launches"] = {f"{k}/{cd}": v for (k, cd), v in ck.launches.items()}
    if any(res["launches"].values()):
        fail(f"families: a CUDA kernel launched on a family's path: {res['launches']}")
    log(f"families: kernel launches during the phase {res['launches']} (all zero)")
    return res


def check_family_autotune(table: dict, kind: str) -> None:
    """Print a family's autotune table; fail on an errored bucket or
    xla_int8, on eligible fused variants, or on another reason than the
    JAX package's."""
    from distributed_tf_serving_tpu_torch.ops.autotune import BASELINE, XLA_INT8

    why = FAMILY_FUSED_REASON.get(kind, NOT_DCN_V2)
    if table.get("pallas_eligible") or table.get("pallas_ineligible_reason") != why:
        fail(f"families: {kind} autotune: fused variants {table.get('pallas_eligible')} "
             f"({table.get('pallas_ineligible_reason')!r}; want ineligible, {why!r})")
    for bucket, row in sorted(table["buckets"].items(), key=lambda kv: int(kv[0])):
        e = row.get(XLA_INT8)
        if "error" in row or e is None or "error" in e:
            fail(f"families: {kind} autotune bucket {bucket}: {row}")
        log(f"autotune: {kind} bucket {bucket}: {BASELINE} step_us="
            f"{row[BASELINE]['step_us']}; {XLA_INT8} step_us={e['step_us']} speedup="
            f"{e['speedup']} max_abs_delta={e['max_abs_delta']} enabled={e['enabled']} -> "
            f"{row['decision']} (fused: {why})")


def two_tower_top_k(dev, batcher, sv, arrays, full) -> dict:
    """two_tower's retrieval head: a batcher with output_top_k = 100 on the
    same servable and request must return the head of a stable descending
    sort of the full scores (`full`, the same batch without top-k), zeros
    elsewhere."""
    import numpy as np

    from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher

    tb = DynamicBatcher(buckets=batcher.buckets, max_wait_us=0, device=dev,
                        output_top_k=FAMILY_TOP_K)
    tb.kernels = batcher.kernels
    tb.start()
    try:
        got = tb.submit(sv, arrays, output_keys=("prediction_node",)
                        ).result(120)["prediction_node"]
        topk_batches = tb.stats.topk_batches
    finally:
        tb.stop()
    n = len(full)
    top = np.argsort(-full, kind="stable")[:FAMILY_TOP_K]
    rest = np.setdiff1d(np.arange(n), top)
    if topk_batches != 1 or not np.array_equal(got[top], full[top]) or np.any(got[rest] != 0):
        fail(f"families: two_tower top-{FAMILY_TOP_K} at n={n} is not the head of a stable "
             f"descending sort of the full scores (topk batches {topk_batches})")
    log(f"families: two_tower n={n} top-{FAMILY_TOP_K}: the head of a stable descending sort "
        f"of the full scores, zeros elsewhere")
    return {"k": FAMILY_TOP_K, "n": n, "head_equal": True, "topk_batches": topk_batches}


# The models phase: multi-model serving from one model config file.
MODELS_POLL_S = 0.5  # --file-system-poll-wait-seconds of the models server
MODELS_CLIENTS = 4
MODELS_STEADY_S = 4.0  # traffic before the first reload, and after the relabel
MODELS_WAIT_S = 120.0  # bound on each wait of the phase
MODELS_TOL = {"bfloat16": 5e-3, "float32": 2e-5}  # against the card's plain forward
MODELS_REPLAYED = 200  # request-log records replayed through replay_warmup_file
# name -> (family, compute dtype, seed, candidates per request); NEW is added
# by a reload during the traffic, CTR's version 2 (seed 4) lands during it.
MODELS = {
    "CTR": ("dcn_v2", "bfloat16", 0, 1000),
    "CTR_F32": ("dcn_v2", "float32", 1, 1000),
    "RANKER": ("deepfm", "bfloat16", 2, 512),
    "NEW": ("dcn_v2", "bfloat16", 3, 1000),
}
CTR_V2_SEED = 4


def _model_entries(base: str, names, labels: dict) -> list:
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

    out = []
    for name in names:
        mc = apis.ModelConfig(name=name, base_path=os.path.join(base, name.lower()),
                              model_platform=MODELS[name][0])
        for label, v in labels.get(name, {}).items():
            mc.version_labels[label] = v
        out.append(mc)
    return out


def _models_reload(stub, base: str, names, labels: dict) -> float:
    """One HandleReloadConfigRequest; its time in ms (a failure fails)."""
    import grpc

    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

    req = apis.ReloadConfigRequest()
    req.config.model_config_list.config.extend(_model_entries(base, names, labels))
    t0 = time.perf_counter()
    try:
        resp = stub.HandleReloadConfigRequest(req, timeout=MODELS_WAIT_S)
    except grpc.RpcError as e:
        fail(f"models: reload {sorted(names)} {labels} failed: {e.code()} {e.details()}")
    if resp.status.error_code != 0:
        fail(f"models: reload {sorted(names)} answered {resp.status}")
    return (time.perf_counter() - t0) * 1e3


def phase_models(dev, name: str) -> dict:
    """Multi-model serving (serving/server.py ModelLifecycle) on the card:
    the CLI server on configs/latency.toml with --model-config-file listing
    CTR (dcn_v2 bf16, seed 0, label stable = 1), CTR_F32 (dcn_v2 f32, seed
    1) and RANKER (deepfm, seed 2), all at the [model] width, written with
    save_servable; a batching-parameters file restating the ladder and
    wait; every request logged. 4 clients send Predicts (n = 1000 to CTR
    by label and to CTR_F32, 512 to RANKER) while a reload adds NEW, CTR v2
    lands, and one reload moves stable to 2 and drops RANKER; then SIGTERM
    during the traffic. Checks in the docstring of the module; then in this
    process the same config through build_stack, where dropping CTR_F32
    must give back its card memory, and the request log replays."""
    import re
    import shutil
    import tempfile
    import threading

    import grpc
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch import codec
    from distributed_tf_serving_tpu_torch.models import Servable, build_model, ctr_signatures
    from distributed_tf_serving_tpu_torch.proto import ModelServiceStub, PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.proto.service_grpc import LARGE_MESSAGE_CHANNEL_OPTIONS
    from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host
    from distributed_tf_serving_tpu_torch.serving.warmup import read_tfrecords
    from distributed_tf_serving_tpu_torch.train.checkpoint import (
        flatten_params,
        save_servable,
        unflatten_like,
    )
    from distributed_tf_serving_tpu_torch.utils.config import load_config
    from google.protobuf import text_format

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    cfg_path = os.path.join(HERE, "configs", "latency.toml")
    loaded = load_config(cfg_path)
    cfg, mc = loaded["server"], loaded["model"]
    F = mc.num_fields
    base = tempfile.mkdtemp(prefix="dts_models_")
    res = {"card": name}
    procs = []
    try:
        # Checkpoints, and the plain forward on the card of every payload
        # under every (model, version), before any clock starts.
        servables, want, payloads = {}, {}, {}
        versions = [(m, 1, MODELS[m][2]) for m in MODELS] + [("CTR", 2, CTR_V2_SEED)]
        for model_name, version, seed in versions:
            kind, cd, _, n = MODELS[model_name]
            model = build_model(kind, dataclasses.replace(mc, name=model_name, compute_dtype=cd))
            params = model.init(seed, "cpu")
            servables[(model_name, version)] = Servable(
                name=model_name, version=version, model=model, params=params,
                signatures=ctr_signatures(F))
            if model_name not in payloads:
                rng = np.random.RandomState(SEED + 3000 + seed)
                payloads[model_name] = [(rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
                                         rng.rand(n, F).astype(np.float32))
                                        for _ in range(MODELS_CLIENTS)]
            on_card = unflatten_like(params, {k: v.to(dev)
                                              for k, v in flatten_params(params).items()})
            with torch.inference_mode():
                want[(model_name, version)] = [model.apply(on_card, {
                    "feat_ids": torch.from_numpy(fold_ids_host(ids, mc.vocab_size)).to(dev),
                    "feat_wts": torch.from_numpy(wts).to(dev)})["prediction_node"].float().cpu()
                    .numpy() for ids, wts in payloads[model_name]]
            del on_card
        torch.cuda.empty_cache()

        def write(model_name: str, version: int) -> None:
            save_servable(os.path.join(base, model_name.lower(), str(version)),
                          servables[(model_name, version)], MODELS[model_name][0])

        for model_name in ("CTR", "CTR_F32", "RANKER", "NEW"):
            write(model_name, 1)
        config_file = os.path.join(out_dir, "models.config")
        msc = apis.ModelServerConfig()
        msc.model_config_list.config.extend(
            _model_entries(base, ("CTR", "CTR_F32", "RANKER"), {"CTR": {"stable": 1}}))
        with open(config_file, "w") as f:
            f.write(text_format.MessageToString(msc))
        batching_file = os.path.join(out_dir, "models_batching.pbtxt")
        with open(batching_file, "w") as f:  # configs/latency.toml's ladder and wait
            f.write(f"max_batch_size {{ value: {cfg.buckets[-1]} }}\n"
                    f"batch_timeout_micros {{ value: {cfg.max_wait_us} }}\n"
                    + "".join(f"allowed_batch_sizes: {b}\n" for b in cfg.buckets))
        request_log = os.path.join(base, "requests.log")
        server_log = os.path.join(out_dir, "models_server.log")
        t0 = time.perf_counter()
        proc, port, logf = _start_cli(
            ["--config", cfg_path, "--model-config-file", config_file,
             "--batching-parameters-file", batching_file, "--request-log-file", request_log,
             "--request-log-sampling", "1.0",
             "--file-system-poll-wait-seconds", str(MODELS_POLL_S)],
            server_log, ready_model="CTR")
        procs.append((proc, logf))
        res["server_start_s"] = time.perf_counter() - t0

        lock = threading.Lock()
        rows = []  # (model, start, end, code, version, max |d| or None)
        stop = threading.Event()
        new_live = threading.Event()
        sigterm_at = [None]
        chans = [grpc.insecure_channel(f"127.0.0.1:{port}", options=LARGE_MESSAGE_CHANNEL_OPTIONS)
                 for _ in range(MODELS_CLIENTS)]

        def request(model_name: str, i: int):
            ids, wts = payloads[model_name][i]
            req = apis.PredictRequest()
            req.model_spec.name = model_name
            if model_name == "CTR":
                req.model_spec.version_label = "stable"
            codec.from_ndarray(ids, out=req.inputs["feat_ids"])
            codec.from_ndarray(wts, out=req.inputs["feat_wts"])
            req.output_filter.append("prediction_node")
            return req

        def client(i: int) -> None:
            stub = PredictionServiceStub(chans[i])
            reqs = {m: request(m, i) for m in MODELS}
            k = i
            while not stop.is_set():
                live = ["CTR", "CTR_F32", "RANKER"] + (["NEW"] if new_live.is_set() else [])
                model_name = live[k % len(live)]
                k += 1
                t0 = time.perf_counter()
                try:
                    resp = stub.Predict(reqs[model_name], timeout=60)
                    code = "OK"
                except grpc.RpcError as e:
                    code, resp = e.code().name, None
                t1 = time.perf_counter()
                version, err = None, None
                if resp is not None:
                    version = resp.model_spec.version.value
                    got = codec.to_ndarray(resp.outputs["prediction_node"])
                    w = want.get((model_name, version))
                    err = (float(np.max(np.abs(got - w[i])))
                           if w is not None and got.shape == w[i].shape
                           and np.all(np.isfinite(got)) else float("inf"))
                with lock:
                    rows.append((model_name, t0, t1, code, version, err))
                if code != "OK" and sigterm_at[0] is not None:
                    time.sleep(0.01)  # the server is going: do not spin on it

        def wait_for(what: str, cond) -> None:
            end = time.perf_counter() + MODELS_WAIT_S
            while not cond():
                if time.perf_counter() > end or proc.poll() is not None:
                    fail(f"models: {what} (server rc {proc.poll()}, log {server_log})")
                time.sleep(0.01)

        def count(pred) -> int:
            with lock:
                return sum(1 for r in rows if pred(r))

        model_stub = ModelServiceStub(chans[0])
        threads = [threading.Thread(target=client, args=(i,)) for i in range(MODELS_CLIENTS)]
        marks = {}
        try:
            for t in threads:
                t.start()
            marks["traffic"] = time.perf_counter()
            time.sleep(MODELS_STEADY_S)
            # 1. A reload adds NEW.
            marks["add"] = time.perf_counter()
            res["add_reload_ms"] = _models_reload(
                model_stub, base, ("CTR", "CTR_F32", "RANKER", "NEW"), {"CTR": {"stable": 1}})
            marks["add_done"] = time.perf_counter()
            new_live.set()
            wait_for("NEW never answered", lambda: count(
                lambda r: r[0] == "NEW" and r[3] == "OK") > 0)
            # 2. CTR v2 lands; 3. once AVAILABLE, stable -> 2 and RANKER dropped.
            write("CTR", 2)
            marks["v2_written"] = time.perf_counter()

            def v2_available() -> bool:
                st = model_stub.GetModelStatus(apis.GetModelStatusRequest(
                    model_spec=apis.ModelSpec(name="CTR")), timeout=10)
                return any(s.version == 2 and s.state == apis.ModelVersionStatus.AVAILABLE
                           for s in st.model_version_status)

            wait_for("CTR v2 never became AVAILABLE", v2_available)
            marks["v2_available"] = time.perf_counter()
            marks["relabel"] = time.perf_counter()
            res["relabel_reload_ms"] = _models_reload(
                model_stub, base, ("CTR", "CTR_F32", "NEW"), {"CTR": {"stable": 2}})
            marks["relabel_done"] = time.perf_counter()
            time.sleep(MODELS_STEADY_S)
            # SIGTERM during the traffic.
            import signal

            sigterm_at[0] = marks["sigterm"] = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=MODELS_WAIT_S)
            except subprocess.TimeoutExpired:
                fail("models: the server did not exit within "
                     f"{MODELS_WAIT_S} s of SIGTERM")
            marks["exit"] = time.perf_counter()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)
            for ch in chans:
                ch.close()
        rc = _stop_cli(proc, logf)
        procs.clear()
        if any(t.is_alive() for t in threads):
            fail("models: a client thread did not stop")
        res["sigterm_to_exit_s"] = marks["exit"] - marks["sigterm"]

        # Checks.
        before_term = [r for r in rows if r[2] < marks["sigterm"]]
        after_term = [r for r in rows if r[2] >= marks["sigterm"]]
        bad = [r for r in before_term if r[0] != "RANKER" and r[3] != "OK"]
        if bad:
            fail(f"models: {len(bad)} failed requests on the models that stay: {bad[:3]}")
        ranker = [r for r in before_term if r[0] == "RANKER"]
        wrong = [r for r in ranker if (r[2] < marks["relabel"] and r[3] != "OK")
                 or (r[1] > marks["relabel_done"] and r[3] != "NOT_FOUND")
                 or r[3] not in ("OK", "NOT_FOUND")]
        if wrong or not any(r[3] == "NOT_FOUND" for r in ranker):
            fail(f"models: RANKER answered {wrong[:3]} around its drop "
                 f"({sum(r[3] == 'NOT_FOUND' for r in ranker)} NOT_FOUND)")
        stable = [r for r in before_term if r[0] == "CTR" and r[3] == "OK"]
        wrong = [r for r in stable if (r[2] < marks["relabel"] and r[4] != 1)
                 or (r[1] > marks["relabel_done"] and r[4] != 2) or r[4] not in (1, 2)]
        if wrong or not any(r[4] == 2 for r in stable):
            fail(f"models: the stable label resolved {wrong[:3]} across the relabel")
        errs = {}
        for r in rows:
            if r[3] == "OK":
                key = f"{r[0]} v{r[4]}"
                errs[key] = max(errs.get(key, 0.0), r[5])
        for key, e in sorted(errs.items()):
            tol = MODELS_TOL[MODELS[key.split()[0]][1]]
            if not e <= tol:
                fail(f"models: responses of {key} are {e} from its plain forward (> {tol})")
        # The drain starts a little after the signal is sent (the handler
        # runs on the server's main thread), so a request ending past the
        # mark may still get the answer it had before: OK from a model that
        # stays, NOT_FOUND from the dropped RANKER. Once the server has
        # refused one request UNAVAILABLE it is draining, and every request
        # started after that refusal must be refused too.
        before_drain = {"RANKER": "NOT_FOUND"}
        wrong = [r for r in after_term if r[3] not in ("UNAVAILABLE", before_drain.get(r[0], "OK"))]
        if wrong:
            fail(f"models: after SIGTERM requests failed with {sorted({r[3] for r in wrong})}, "
                 f"not only UNAVAILABLE: {wrong[:3]}")
        refused = [r[2] for r in after_term if r[3] == "UNAVAILABLE"]
        late = [r for r in after_term if refused and r[1] > min(refused) and r[3] != "UNAVAILABLE"]
        if late:
            fail(f"models: {len(late)} requests started after the first drain refusal "
                 f"were not refused UNAVAILABLE: {late[:3]}")
        with open(server_log) as f:
            text = f.read()
        m = re.search(r"kernel launches at shutdown: (\{.*\})$", text, re.M)
        d = re.search(r"shutdown complete \(drained=(\w+), ([\d.]+)s\)", text)
        if rc != 0 or d is None or d.group(1) != "True" or m is None:
            fail(f"models: the server exited {rc}, drain line {d and d.group(0)} "
                 f"(log {server_log})")
        res["launches"] = json.loads(m.group(1))
        res["drain_s"] = float(d.group(2))
        for key in ("fused_serve/bfloat16", "fused_serve/float32"):
            if res["launches"].get(key, 0) <= 0:
                fail(f"models: the server launched {key} no time: {res['launches']}")
        res["after_sigterm"] = {c: sum(r[3] == c for r in after_term)
                                for c in ("OK", "NOT_FOUND", "UNAVAILABLE")}
        res["max_abs_err"] = errs
        res["requests"] = {c: sum(r[3] == c for r in rows) for c in sorted({r[3] for r in rows})}
        res["add_to_first_new_ok_s"] = min(r[2] for r in rows if r[0] == "NEW"
                                           and r[3] == "OK") - marks["add"]
        res["relabel_to_first_v2_s"] = min(r[2] for r in stable if r[4] == 2) - marks["relabel"]
        res["v2_written_to_available_s"] = marks["v2_available"] - marks["v2_written"]
        lo, hi = marks["traffic"] + 1.0, marks["add"]
        lo2, hi2 = marks["relabel_done"] + 0.5, marks["sigterm"]
        res["steady"] = {
            "before_reloads": {m: _percentiles([(r[2] - r[1]) * 1e3 for r in rows
                                                if r[0] == m and r[3] == "OK"
                                                and lo <= r[1] and r[2] < hi])
                               for m in ("CTR", "CTR_F32", "RANKER")},
            "after_relabel": {m: _percentiles([(r[2] - r[1]) * 1e3 for r in rows
                                               if r[0] == m and r[3] == "OK"
                                               and lo2 <= r[1] and r[2] < hi2])
                              for m in ("CTR", "CTR_F32", "NEW")},
        }

        # The request log: every record a Predict of a served model; the
        # first MODELS_REPLAYED replay through replay_warmup_file below.
        names, kept = {}, []
        for rec in read_tfrecords(request_log):
            plog = apis.PredictionLog.FromString(rec)
            if plog.WhichOneof("log_type") != "predict_log":
                fail(f"models: a request-log record is a {plog.WhichOneof('log_type')}")
            n = plog.predict_log.request.model_spec.name
            if n not in MODELS:
                fail(f"models: a request-log record names model {n!r}")
            names[n] = names.get(n, 0) + 1
            if len(kept) < MODELS_REPLAYED:
                kept.append(rec)
        if not kept:
            fail("models: the request log holds no record")
        res["request_log"] = {"records": names, "bytes": os.path.getsize(request_log)}
        replay_file = os.path.join(base, "replay.log")
        from distributed_tf_serving_tpu_torch.serving.warmup import write_tfrecords

        write_tfrecords(replay_file, kept)
        os.unlink(request_log)

        res["memory"] = _models_memory(config_file, cfg, base, replay_file, payloads)
        for label, p in res["steady"].items():
            for m, q in p.items():
                log(f"models: {label} {m}: " + (
                    f"{q['requests']} requests p50 {q['p50_ms']:.3f} ms p99 {q['p99_ms']:.3f} ms"
                    if q["requests"] else "no requests") + f" ({name})")
        log(f"models: reload add NEW {res['add_reload_ms']:.1f} ms, add -> first NEW OK "
            f"{res['add_to_first_new_ok_s']:.3f} s; v2 written -> AVAILABLE "
            f"{res['v2_written_to_available_s']:.3f} s; relabel + drop RANKER "
            f"{res['relabel_reload_ms']:.1f} ms, relabel -> first v2 "
            f"{res['relabel_to_first_v2_s']:.3f} s ({name})")
        log(f"models: requests {res['requests']}, max |dscore| vs plain forward "
            f"{ {k: round(v, 7) for k, v in errs.items()} }")
        log(f"models: SIGTERM -> exit {res['sigterm_to_exit_s']:.3f} s, drain "
            f"{res['drain_s']:.3f} s (drained=True), after SIGTERM {res['after_sigterm']}; "
            f"launches {res['launches']} ({name})")
        log(f"models: request log {res['request_log']}, replayed "
            f"{res['memory']['replayed']} records; memory: {res['memory']['before_load']} B "
            f"before CTR_F32 was loaded, {res['memory']['loaded']} B loaded, "
            f"{res['memory']['after_drop']} B after its drop (retained "
            f"{res['memory']['retained_bytes']} B; device input cache "
            f"{res['memory']['input_cache_bytes_cleared']} B cleared before the reads) ({name})")
    finally:
        for proc, logf in procs:
            _stop_cli(proc, logf)
        shutil.rmtree(base, ignore_errors=True)
    return res


def _models_memory(config_file: str, cfg, base: str, replay_file: str, payloads) -> dict:
    """In this process: build_stack on the models config, replay the
    request log's first records, and take CTR_F32 out, in again (one
    request), and out: torch.cuda.memory_allocated after the first drop
    and after the second must agree within 1 MiB (read as retire_memory
    does: the dropped model dies on whichever thread lets go of its last
    batch)."""
    import gc
    import weakref

    import torch

    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.serving.server import build_stack
    from distributed_tf_serving_tpu_torch.serving.warmup import replay_warmup_file

    cached = []  # the device input cache's bytes at each read

    def allocated() -> int:
        gc.collect()
        torch.cuda.synchronize()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        # The device input cache belongs to the batcher, not to a version:
        # its entries stay resident, so their bytes are reported and the
        # cache is cleared before the read.
        cached.append(batcher.input_cache.nbytes())
        batcher.input_cache.clear()
        return torch.cuda.memory_allocated()

    def reload(names) -> None:
        req = apis.ReloadConfigRequest()
        labels = {"CTR": {"stable": 1}}
        req.config.model_config_list.config.extend(_model_entries(base, names, labels))
        impl.handle_reload_config(req)

    impl, batcher, _ = build_stack(dataclasses.replace(
        cfg, model_config_file=config_file, file_system_poll_wait_seconds=3600.0), None, "cuda")
    try:
        if sorted(impl.registry.models()) != ["CTR", "CTR_F32", "RANKER"]:
            fail(f"models: build_stack served {impl.registry.models()}")
        replayed = replay_warmup_file(replay_file, impl.registry.resolve("CTR"), batcher)
        reload(("CTR", "RANKER"))
        before = allocated()
        reload(("CTR", "CTR_F32", "RANKER"))
        sv = impl.registry.resolve("CTR_F32")
        ids, wts = payloads["CTR_F32"][0]
        batcher.submit(sv, {"feat_ids": ids, "feat_wts": wts}).result(60)
        torch.cuda.synchronize()
        loaded = torch.cuda.memory_allocated()
        ref = weakref.ref(sv)
        table = weakref.ref(sv.params["embedding"])
        sv = None
        reload(("CTR", "RANKER"))
        t0 = time.perf_counter()
        while table() is not None and time.perf_counter() - t0 < RETIRE_SETTLE_S:
            gc.collect()
            time.sleep(0.01)
        t1 = time.perf_counter()
        while True:
            after = allocated()
            if after <= before or time.perf_counter() - t1 > RETIRE_SETTLE_S:
                break
            time.sleep(0.005)
        res = {"replayed": replayed, "before_load": before, "loaded": loaded,
               "after_drop": after, "retained_bytes": after - before,
               "input_cache_bytes_cleared": {"before_load": cached[0],
                                             "after_drop": max(cached[1:])},
               "servable_collected": ref() is None, "table_collected": table() is None,
               "drain_s": t1 - t0, "settle_s": time.perf_counter() - t1}
    finally:
        impl.model_lifecycle.stop()
        batcher.stop()
    if replayed <= 0:
        fail("models: the request log replayed no record")
    if not res["servable_collected"] or res["retained_bytes"] > (1 << 20):
        fail(f"models: dropping CTR_F32 kept {res['retained_bytes']} B on the card "
             f"(collected {res['servable_collected']})")
    return res


REST_SIZES = (7, 1000, 2048)  # configs/latency.toml's candidate counts
REST_REPEATS = 10  # REST Predicts per size and format, and gRPC Predicts per size
REST_CLASSIFY = 5  # REST Classify requests of n = 7 Examples
REST_PROFILED = 5  # REST Predicts per size of the in-process path under torch.profiler
REST_TRACE_IDS = {"rest": "0af7651916cd43dd8448eb211c80319c",
                  "grpc": "4bf92f3577b34da6a3ce929d0e0e4736"}
REST_SERVICE_PHASES = ("predict.decode", "predict.execute", "predict.encode")
REST_BATCH_PHASES = ("batch.queue_wait", "batch.dispatch", "batch.cache", "batch.jitcall",
                     "readback.issue", "readback.wait")


class _Http:
    """One keep-alive HTTP/1.1 connection to a REST gateway on 127.0.0.1."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)

    def call(self, method: str, path: str, body: bytes | None = None,
             headers: dict | None = None) -> tuple[int, bytes]:
        hdrs = {"Content-Type": "application/json"} if body is not None else {}
        hdrs.update(headers or {})
        self.conn.request(method, path, body=body, headers=hdrs)
        r = self.conn.getresponse()
        return r.status, r.read()

    def json(self, method: str, path: str, body: bytes | None = None,
             headers: dict | None = None):
        status, data = self.call(method, path, body, headers)
        if status != 200:
            fail(f"rest: {method} {path} answered {status}: {data[:300]!r}")
        return json.loads(data)

    def close(self) -> None:
        self.conn.close()


def _wait_port(port: int, proc=None, timeout: float = 60.0) -> None:
    import socket

    end = time.perf_counter() + timeout
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            if proc is not None and proc.poll() is not None:
                fail(f"the server exited with {proc.returncode} before its REST port opened")
            if time.perf_counter() > end:
                fail(f"REST port {port} did not open within {timeout} s")
            time.sleep(0.1)


def _rest_bodies(ids, wts) -> dict[str, bytes]:
    """The row (`instances`) and columnar (`inputs`) bodies of one payload."""
    rows = {"instances": [{"feat_ids": i, "feat_wts": w}
                          for i, w in zip(ids.tolist(), wts.tolist())]}
    cols = {"inputs": {"feat_ids": ids.tolist(), "feat_wts": wts.tolist()}}
    return {"rows": json.dumps(rows).encode(), "columns": json.dumps(cols).encode()}


def _rest_scores(fmt: str, body: dict):
    import numpy as np

    if fmt == "rows":
        return np.asarray([p["prediction_node"] for p in body["predictions"]], np.float32)
    return np.asarray(body["outputs"]["prediction_node"], np.float32)


def _grpc_predict(stub, ids, wts, metadata=None):
    """A Predict of the REST body's content (tensor_content, no output
    filter: the REST path's request): (scores, ms)."""
    from distributed_tf_serving_tpu_torch import codec
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

    req = apis.PredictRequest()
    req.model_spec.name = "DCN"
    codec.from_ndarray(ids, use_tensor_content=True, out=req.inputs["feat_ids"])
    codec.from_ndarray(wts, use_tensor_content=True, out=req.inputs["feat_wts"])
    t0 = time.perf_counter()
    resp = stub.Predict(req, timeout=120, metadata=metadata)
    ms = (time.perf_counter() - t0) * 1e3
    return codec.to_ndarray(resp.outputs["prediction_node"]), ms


def _span_children(root: dict) -> dict:
    out: dict = {}
    for c in root["children"]:
        out.setdefault(c["name"], []).append(c)
    return out


def _json_share(tracez: dict, seen: set) -> list[float]:
    """Per REST Predict root not seen before: the share of its time outside
    predict.decode / execute / encode (the gateway's JSON parse, array build
    and response JSON)."""
    shares = []
    for t in tracez["traces"]:
        for root in t["spans"]:
            if root["name"] != "server.REST.Predict" or root["span_id"] in seen:
                continue
            seen.add(root["span_id"])
            kids = _span_children(root)
            inside = sum(c["duration_us"] for name in REST_SERVICE_PHASES
                         for c in kids.get(name, ()))
            if root["duration_us"] > 0 and all(name in kids for name in REST_SERVICE_PHASES):
                shares.append(1.0 - inside / root["duration_us"])
    return shares


def _rest_in_process(impl, metrics):
    """The REST gateway over an in-process stack, on its own event loop in a
    thread: (port, stop)."""
    import asyncio
    import threading

    from distributed_tf_serving_tpu_torch.serving.rest import start_rest_gateway

    loop = asyncio.new_event_loop()
    ready, up = {}, threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        try:
            ready["runner"], ready["port"] = loop.run_until_complete(
                start_rest_gateway(impl, "127.0.0.1", 0, metrics))
        except BaseException as exc:  # noqa: BLE001 — reported below
            ready["error"] = exc
            return
        finally:
            up.set()
        loop.run_forever()

    th = threading.Thread(target=run, name="rest-in-process", daemon=True)
    th.start()
    if not up.wait(60) or "error" in ready:
        fail(f"rest: the in-process gateway did not start: {ready.get('error')}")

    def stop():
        asyncio.run_coroutine_threadsafe(ready["runner"].cleanup(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        th.join(30)
        loop.close()

    return ready["port"], stop


def _rest_profiled_path(dev, kc, cfg, model_cfg, payloads) -> dict:
    """The REST path in this process, under torch.profiler: build_stack on
    the phase's config (its autotune writes the table the CLI servers
    adopt), the gateway over it, the launch counters zeroed just before
    REST_PROFILED Predicts per size and read just after. Every batch must
    launch the fused serve kernel (the wrappers' launch counters equal to
    the batches) and no GEMM runs (no plain forward). The profiler's count
    of fused_serve kernels is printed beside the counters: its tracer has
    lost a launch inside the window on this path, so it is not the gate."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.serving.server import build_stack
    from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics

    impl, batcher, servable = build_stack(cfg, model_cfg, "cuda", seed=SEED, kernels_config=kc)
    table = batcher.kernels.snapshot()["tables"][f"{servable.name}:{servable.version}"]
    check_autotune(table, "rest")
    port, stop = _rest_in_process(impl, ServerMetrics())
    http = _Http(port)
    try:
        bodies = {n: _rest_bodies(ids, wts)["rows"] for n, (ids, wts) in payloads.items()}
        for n, body in bodies.items():  # one untimed request per size first
            http.json("POST", "/v1/models/DCN:predict", body)
        torch.cuda.synchronize()
        # After the earlier phases the profiler has lost the first launch of
        # a kernel in its window (and a marker launched before the traffic,
        # with the batch's own D2H copy kept): so the window opens with a
        # warmup step, in which the tracer runs and one request per size
        # launches every kernel the counted traffic will, and only the
        # active step after it is kept.
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for n, body in bodies.items():
                http.json("POST", "/v1/models/DCN:predict", body)
            torch.cuda.synchronize()
            time.sleep(0.2)
            b0 = batcher.stats.batches
            ck.reset_launches()  # this path's counts: zeroed just before, read just after
            prof.step()
            for n, body in bodies.items():
                for _ in range(REST_PROFILED):
                    http.json("POST", "/v1/models/DCN:predict", body)
            torch.cuda.synchronize()
            launches = {f"{k}/{cd}": v for (k, cd), v in ck.launches.items()}
            batches = batcher.stats.batches - b0
            prof.step()
    finally:
        http.close()
        stop()
        batcher.stop()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in events]
    fused = sum(1 for nm in names if "fused_serve" in nm)
    gemms = sorted({nm for nm in names if "gemm" in nm.lower()})
    res = {"requests": len(payloads) * REST_PROFILED, "batches": batches,
           "profiler_fused_serve_kernels": fused, "gemm_kernels": gemms,
           "launches": launches, "autotune": table}
    counted = launches.get("fused_serve/bfloat16", 0) + launches.get("fused_serve_int8/bfloat16", 0)
    log(f"rest: in-process REST path under torch.profiler: {res['requests']} Predicts, "
        f"{batches} batches, {counted} counted fused serve launches (the profiler's "
        f"fused_serve kernels: {fused}), GEMM kernels {len(gemms)}")
    if not names or not fused:
        fail("rest: torch.profiler recorded no fused_serve kernel over the REST traffic")
    if fused < batches:
        log(f"rest: the profiler lost {batches - fused} of {batches} fused_serve kernels "
            f"(the counters saw every launch)")
    if counted != batches:
        # Where the profile's events fell (µs from its first event), so a
        # loss shows whether it was at an edge of the window.
        t0 = min(e.time_range.start for e in events)
        timeline = [(round(e.time_range.start - t0), e.name[:40]) for e in events
                    if "fused_serve" in e.name or e is events[0] or e is events[-1]]
        fail(f"rest: {batches} REST batches but {fused} fused_serve kernels in the profile and "
             f"{counted} counted launches; profile timeline {timeline}")
    if gemms:
        fail(f"rest: the REST path ran GEMM kernels (a plain forward): {gemms[:4]}")
    return res


def _reference(dev, model_cfg, decisions: dict, buckets, payloads) -> dict:
    """The card's plain forward (model.apply) of every payload on the seed-0
    demo weights, on the tree the server's decision picked for the bucket."""
    import torch

    from distributed_tf_serving_tpu_torch.models import ServableRegistry
    from distributed_tf_serving_tpu_torch.ops.quantize import quantize_params
    from distributed_tf_serving_tpu_torch.serving.batcher import bucket_for
    from distributed_tf_serving_tpu_torch.serving.server import load_demo_servable

    sv = load_demo_servable(ServableRegistry(), kind="dcn_v2", name="DCN", seed=SEED,
                            config=model_cfg, device=dev)
    qparams = None
    want = {}
    for n, (ids, wts) in payloads.items():
        dec = decisions.get(str(bucket_for(n, buckets))) or {}
        params = sv.params
        if dec.get("quantized"):
            qparams = qparams if qparams is not None else quantize_params(sv.params)
            params = qparams
        with torch.inference_mode():
            want[n] = sv.model.apply(params, {
                "feat_ids": torch.from_numpy(ids).to(dev),
                "feat_wts": torch.from_numpy(wts).to(dev)})["prediction_node"].float().cpu().numpy()
    return want


def _grpc_p50(stub, payloads, sizes=(7, 1000)) -> dict:
    out = {}
    for n in sizes:
        ids, wts = payloads[n]
        _grpc_predict(stub, ids, wts)
        out[n] = statistics.median(_grpc_predict(stub, ids, wts)[1] for _ in range(REST_REPEATS))
    return out


def phase_rest(dev, name: str) -> dict:
    """The REST gateway and the telemetry plane (serving/rest.py,
    utils/metrics.py, utils/tracing.py) on the card: configs/latency.toml
    with [kernels] enabled, seed-0 weights. Checks in the docstring of the
    module."""
    import subprocess as sp

    import grpc
    import numpy as np

    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto.service_grpc import LARGE_MESSAGE_CHANNEL_OPTIONS
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    out_dir = os.path.join(HERE, "chiprun_out")
    kc = kernels_plane_config("_rest")
    toml = os.path.join(out_dir, "kernels_plane_rest.toml")
    loaded = load_config(toml)
    cfg, model_cfg = loaded["server"], loaded["model"]
    rng = np.random.RandomState(SEED + 5000)
    payloads = {n: (rng.randint(0, 1 << 40, size=(n, model_cfg.num_fields)).astype(np.int64),
                    rng.rand(n, model_cfg.num_fields).astype(np.float32))
                for n in REST_SIZES}
    res = {"card": name, "path": _rest_profiled_path(dev, kc, cfg, model_cfg, payloads)}

    # The CLI server with the REST gateway, tracing and the metrics log line.
    server_log = os.path.join(out_dir, "rest_server.log")
    rest_port = _free_port()
    t0 = time.perf_counter()
    proc, port, logf = _start_cli(["--config", toml, "--rest-port", str(rest_port), "--tracing",
                                   "--metrics-every-s", "1"], server_log)
    _wait_port(rest_port, proc)
    res["server_start_s"] = time.perf_counter() - t0
    ch = grpc.insecure_channel(f"127.0.0.1:{port}", options=LARGE_MESSAGE_CHANNEL_OPTIONS)
    stub = PredictionServiceStub(ch)
    http = _Http(rest_port)
    sent = {"REST.Predict": 0, "REST.Classify": 0, "Predict": 0}
    try:
        mon = http.json("GET", "/monitoring?section=kernels")["kernels"]
        decisions = mon["decisions"]["DCN:1"]
        want = _reference(dev, model_cfg, decisions, cfg.buckets, payloads)
        lat = {}
        shares = {}
        seen: set = set()
        worst = 0.0
        for n, (ids, wts) in payloads.items():
            grpc_scores, grpc_ms = None, []
            _grpc_predict(stub, ids, wts)  # untimed first request per size
            sent["Predict"] += 1
            for _ in range(REST_REPEATS):
                grpc_scores, ms = _grpc_predict(stub, ids, wts)
                grpc_ms.append(ms)
            sent["Predict"] += REST_REPEATS
            lat[f"grpc/{n}"] = _percentiles(grpc_ms)
            for fmt, body in _rest_bodies(ids, wts).items():
                rest_ms = []
                for _ in range(REST_REPEATS):
                    t1 = time.perf_counter()
                    status, data = http.call("POST", "/v1/models/DCN:predict", body)
                    rest_ms.append((time.perf_counter() - t1) * 1e3)
                    if status != 200:
                        fail(f"rest: Predict n={n} ({fmt}) answered {status}: {data[:300]!r}")
                    got = _rest_scores(fmt, json.loads(data))
                    if got.shape != (n,) or not np.array_equal(got, grpc_scores):
                        fail(f"rest: n={n} ({fmt}) scores are not bit-identical to the gRPC "
                             f"response of the same payload (max |d| "
                             f"{np.max(np.abs(got - grpc_scores)) if got.shape == (n,) else got.shape})")
                sent["REST.Predict"] += REST_REPEATS
                lat[f"rest_{fmt}/{n}"] = _percentiles(rest_ms)
                shares[f"{fmt}/{n}"] = _json_share(
                    http.json("GET", "/tracez?limit=256"), seen)
            err = float(np.max(np.abs(grpc_scores - want[n])))
            worst = max(worst, err)
            if not np.all(np.isfinite(grpc_scores)) or err > APPLY_TOL:
                fail(f"rest: n={n}: max |dscore| vs the card's plain forward {err} > {APPLY_TOL}")
            log(f"rest: n={n} REST rows p50 {lat[f'rest_rows/{n}']['p50_ms']:.3f} / p99 "
                f"{lat[f'rest_rows/{n}']['p99_ms']:.3f} ms, columns p50 "
                f"{lat[f'rest_columns/{n}']['p50_ms']:.3f} / p99 "
                f"{lat[f'rest_columns/{n}']['p99_ms']:.3f} ms, gRPC p50 "
                f"{lat[f'grpc/{n}']['p50_ms']:.3f} ms; share outside decode/execute/encode "
                f"rows {statistics.median(shares[f'rows/{n}']):.3f}, columns "
                f"{statistics.median(shares[f'columns/{n}']):.3f}; max |d| {err:.3g} ({name})")
        ids7, wts7 = payloads[7]
        examples = json.dumps({"examples": [{"feat_ids": i, "feat_wts": w} for i, w in
                                            zip(ids7.tolist(), wts7.tolist())]}).encode()
        for _ in range(REST_CLASSIFY):
            body = http.json("POST", "/v1/models/DCN:classify", examples)
            p1 = np.asarray([dict(r)["1"] for r in body["results"]], np.float32)
            if p1.shape != (7,) or float(np.max(np.abs(p1 - want[7]))) > APPLY_TOL:
                fail(f"rest: Classify scores {p1} are not the plain forward's {want[7]}")
        sent["REST.Classify"] += REST_CLASSIFY
        # One REST and one gRPC Predict carrying a known traceparent.
        tp = "00-{}-00f067aa0ba902b7-01"
        http.json("POST", "/v1/models/DCN:predict", _rest_bodies(ids7, wts7)["rows"],
                  headers={"traceparent": tp.format(REST_TRACE_IDS["rest"])})
        _grpc_predict(stub, ids7, wts7,
                      metadata=(("traceparent", tp.format(REST_TRACE_IDS["grpc"])),))
        sent["REST.Predict"] += 1
        sent["Predict"] += 1
        traced = _rest_tracez_checks(http)
        res["tracing_on_grpc_p50_ms"] = _grpc_p50(stub, payloads)
        sent["Predict"] += 2 * (REST_REPEATS + 1)
        res["monitoring"] = _rest_monitoring_checks(http, sent)
        res["prometheus_lines"] = _rest_prometheus_checks(http, sent)
    finally:
        http.close()
        ch.close()
        rc = _stop_cli(proc, logf)
    if rc != 0:
        fail(f"rest: the server exited with {rc} after SIGTERM (log {server_log})")
    with open(server_log) as f:
        text = f.read()
    metrics_lines = [ln for ln in text.splitlines() if " metrics {" in ln]
    if not metrics_lines:
        fail(f"rest: the server logged no `metrics {{...}}` line ({server_log})")
    res["launches_server"] = _server_log(server_log)["shutdown"] or {}
    res.update(latency=lat, json_share={k: statistics.median(v) for k, v in shares.items()},
               max_abs_err=worst, traced=traced, metrics_lines=len(metrics_lines), sent=sent)

    # The same tree without --tracing: the tracing cost at n = 7 and 1000.
    proc, port, logf = _start_cli(["--config", toml], os.path.join(out_dir, "rest_plain.log"))
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}",
                                   options=LARGE_MESSAGE_CHANNEL_OPTIONS) as ch2:
            res["tracing_off_grpc_p50_ms"] = _grpc_p50(PredictionServiceStub(ch2), payloads)
    finally:
        if _stop_cli(proc, logf) != 0:
            fail("rest: the server without --tracing did not exit 0 after SIGTERM")
    on, off = res["tracing_on_grpc_p50_ms"], res["tracing_off_grpc_p50_ms"]
    log("rest: gRPC p50 with --tracing / without: " + ", ".join(
        f"n={n} {on[n]:.3f} / {off[n]:.3f} ms" for n in sorted(on)) + f" ({name})")
    log(f"rest: {sent} answered; launches on the REST server (its life) "
        f"{res['launches_server']}; {len(metrics_lines)} metrics lines; SIGTERM -> exit 0")
    return res


def _rest_tracez_checks(http) -> dict:
    """Both known trace ids in /tracez, each root with the service's phases
    and the batch's replayed ones as children; the Chrome export parses."""
    body = http.json("GET", "/tracez?limit=1000")
    if not body.get("enabled"):
        fail("rest: /tracez says tracing is off on a --tracing server")
    traces = {t["trace_id"]: t for t in body["traces"]}
    out = {}
    for kind, root_name in (("rest", "server.REST.Predict"), ("grpc", "server.Predict")):
        t = traces.get(REST_TRACE_IDS[kind])
        if t is None:
            fail(f"rest: /tracez lacks the {kind} trace {REST_TRACE_IDS[kind]}")
        roots = [s for s in t["spans"] if s["name"] == root_name]
        if not roots:
            fail(f"rest: the {kind} trace has no {root_name} root: "
                 f"{[s['name'] for s in t['spans']]}")
        kids = _span_children(roots[0])
        missing = [p for p in REST_SERVICE_PHASES + REST_BATCH_PHASES if p not in kids]
        if missing:
            fail(f"rest: the {kind} trace's {root_name} lacks children {missing} "
                 f"(has {sorted(kids)})")
        out[kind] = {"duration_us": roots[0]["duration_us"],
                     "children_us": {k: sum(c["duration_us"] for c in v) for k, v in kids.items()}}
    status, data = http.call("GET", "/tracez?format=chrome")
    chrome = json.loads(data) if status == 200 else {}
    if not chrome.get("traceEvents"):
        fail(f"rest: /tracez?format=chrome answered {status} without traceEvents")
    out["chrome_events"] = len(chrome["traceEvents"])
    log(f"rest: /tracez holds the REST and gRPC trace ids with their phases; chrome export "
        f"{out['chrome_events']} events")
    return out


def _rest_monitoring_checks(http, sent: dict) -> dict:
    mon = http.json("GET", "/monitoring")
    rpcs = mon["rpcs"]
    for entry, n in sent.items():
        got = rpcs.get(entry, {})
        if (got.get("ok"), got.get("errors")) != (n, 0):
            fail(f"rest: /monitoring counts {entry} ok={got.get('ok')} "
                 f"errors={got.get('errors')}, sent {n}")
    for block in ("batcher", "pipeline", "kernels", "phases"):
        if block not in mon:
            fail(f"rest: /monitoring has no {block} block: {sorted(mon)}")
    for phase in ("batch.cache", "batch.jitcall", "readback.wait"):
        if mon["phases"].get(phase, {}).get("count", 0) <= 0:
            fail(f"rest: /monitoring phases count no {phase}: {sorted(mon['phases'])}")
    log("rest: /monitoring phases mean_us " + ", ".join(
        f"{k} {v['mean_us']}" for k, v in sorted(mon["phases"].items())))
    return {"rpcs": {k: {"ok": v["ok"], "errors": v["errors"], "p50_ms": v["p50_ms"],
                         "p99_ms": v["p99_ms"]} for k, v in rpcs.items()},
            "phases": mon["phases"], "batcher": mon["batcher"], "pipeline": mon["pipeline"],
            "kernels_counters": mon["kernels"].get("counters")}


def _rest_prometheus_checks(http, sent: dict) -> int:
    status, data = http.call("GET", "/monitoring/prometheus/metrics")
    if status != 200:
        fail(f"rest: /monitoring/prometheus/metrics answered {status}")
    lint = subprocess.run([sys.executable, os.path.join(HERE, "tools", "check_prom.py"), "-"],
                          input=data, capture_output=True, timeout=60)
    if lint.returncode != 0:
        fail(f"rest: tools/check_prom.py rejects the exposition: "
             f"{lint.stdout.decode()[-500:]} {lint.stderr.decode()[-500:]}")
    text = data.decode()
    line = (f':tensorflow:serving:request_count{{entrypoint="REST.Predict",status="OK"}} '
            f'{sent["REST.Predict"]}')
    if line not in text.splitlines():
        fail(f"rest: the exposition lacks `{line}`")
    kernel_lines = [ln for ln in text.splitlines() if ln.startswith("dts_tpu_kernel_")]
    if not kernel_lines:
        fail("rest: the exposition has no dts_tpu_kernel_* line")
    log(f"rest: Prometheus text lint-clean, {len(text.splitlines())} lines, "
        f"{len(kernel_lines)} dts_tpu_kernel_* samples")
    return len(text.splitlines())


# The aio phase: the coroutine gRPC server and the batcher's failure paths.
AIO_SIZES = (7, 500, 1000, 2048)  # latency.toml's counts, and 500 so every bucket serves
AIO_REPEATS = 20  # Predicts per size on each server
AIO_EXAMPLES = 5  # Classify and Regress requests of n = 7 Examples
AIO_STREAM = (2048, 256)  # PredictStream candidates, chunk
AIO_LOOP = (500, 1000, (4, 16))  # closed loop: Predicts, candidates each, client counts
AIO_BREAKER_S = 2.0  # breaker_timeout_s of the breaker's batcher
AIO_FAULTS = (("decode", "INVALID_ARGUMENT"), ("readback", "DATA_LOSS"),
              ("executor_abort", "INTERNAL"))
# The window check: requests of the largest bucket never coalesce, so each
# is one batch of one shape on both servers and the bits compare.
AIO_WINDOW = (2048, 4, 25)  # candidates, clients, Predicts per client
AIO_RING_SIZES = (7, 1000, 2048)
AIO_RING_REPEATS = 5


def _aio_loop():
    """One event loop in a thread that hosts create_server_async servers:
    (add(impl) -> port, stop)."""
    import asyncio
    import threading

    from distributed_tf_serving_tpu_torch.serving import create_server_async

    loop = asyncio.new_event_loop()
    servers = []

    def run():
        asyncio.set_event_loop(loop)
        loop.run_forever()

    th = threading.Thread(target=run, name="aio-server", daemon=True)
    th.start()

    async def start(impl):
        server, port = create_server_async(impl, "127.0.0.1:0")
        await server.start()
        return server, port

    def add(impl) -> int:
        server, port = asyncio.run_coroutine_threadsafe(start(impl), loop).result(60)
        servers.append(server)
        return port

    def stop():
        for server in servers:
            asyncio.run_coroutine_threadsafe(server.stop(0), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        th.join(30)
        loop.close()

    return add, stop


def _channel(port: int):
    import grpc

    from distributed_tf_serving_tpu_torch.proto.service_grpc import LARGE_MESSAGE_CHANNEL_OPTIONS

    return grpc.insecure_channel(f"127.0.0.1:{port}", options=LARGE_MESSAGE_CHANNEL_OPTIONS)


def _scores_of(resp):
    from distributed_tf_serving_tpu_torch import codec

    return codec.to_ndarray(resp.outputs["prediction_node"])


def _examples_request(kind: str, ids, wts):
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.serving.example_codec import make_example

    req = apis.ClassificationRequest() if kind == "classify" else apis.RegressionRequest()
    req.model_spec.name = "DCN"
    for i in range(len(ids)):
        req.input.example_list.examples.append(make_example(ids[i], wts[i]))
    return req


def _example_scores(kind: str, resp):
    import numpy as np

    if kind == "classify":
        return np.asarray([dict((c.label, c.score) for c in cl.classes)["1"]
                           for cl in resp.result.classifications], np.float32)
    return np.asarray([r.value for r in resp.result.regressions], np.float32)


def _closed_loop_n(port: int, payload, clients: int, total: int) -> dict:
    """`total` gRPC Predicts of `payload` shared out to `clients` threads,
    each on its own channel, back to back: p50 / p99 / QPS over the wall."""
    import threading

    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub

    lock = threading.Lock()
    left = [total]
    lat, errors = [], []
    chans = [_channel(port) for _ in range(clients)]
    req = _request(*payload)
    barrier = threading.Barrier(clients + 1)

    def client(k):
        stub = PredictionServiceStub(chans[k])
        stub.Predict(req, timeout=60)  # channel up before the clock starts
        barrier.wait(timeout=120)
        mine = []
        try:
            while True:
                with lock:
                    if left[0] <= 0:
                        break
                    left[0] -= 1
                t0 = time.perf_counter()
                stub.Predict(req, timeout=60)
                mine.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
        with lock:
            lat.extend(mine)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    try:
        for t in threads:
            t.start()
        barrier.wait(timeout=120)
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        for ch in chans:
            ch.close()
    if errors or any(t.is_alive() for t in threads) or len(lat) != total:
        fail(f"aio: closed loop on port {port}: {len(lat)} of {total} answered, "
             f"errors {errors[:3]}")
    return {"requests": len(lat), "clients": clients, "wall_s": wall, "qps": len(lat) / wall,
            **_percentiles(lat)}


def _answers(port: int, payloads: list, per_client: int) -> tuple[list, float]:
    """Each payload sent `per_client` times by its own client thread: (the
    answer of each payload — every repeat must carry its bits —, QPS)."""
    import threading

    import numpy as np

    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub

    got: list = [None] * len(payloads)
    errors = []
    chans = [_channel(port) for _ in payloads]

    def client(k):
        stub = PredictionServiceStub(chans[k])
        req = _request(*payloads[k])
        try:
            for _ in range(per_client):
                scores = _scores_of(stub.Predict(req, timeout=60))
                if got[k] is None:
                    got[k] = scores
                elif not np.array_equal(scores, got[k]):
                    errors.append(f"client {k}: a repeat changed the scores")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(len(payloads))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    for ch in chans:
        ch.close()
    if errors or any(t.is_alive() for t in threads):
        fail(f"aio: clients on port {port}: {errors[:3]}")
    return got, len(payloads) * per_client / wall


def _rpc_code(fn) -> str | None:
    """The status name an RPC ended with (None = OK)."""
    import grpc

    try:
        fn()
        return None
    except grpc.RpcError as e:
        return e.code().name


def _until_true(pred, what: str, timeout: float = 30.0) -> float:
    end = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > end:
            fail(f"aio: {what} within {timeout} s")
        time.sleep(0.001)
    return time.perf_counter()


def _aio_serving(name, batcher, aio_port, sync_port, payloads, want) -> dict:
    """Predict / Classify / Regress / PredictStream / metadata over the aio
    server against the sync server on the same impl; the launch counters
    zeroed just before the aio requests and read just after."""
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.proto import (
        HealthCheckRequest,
        HealthStub,
        ModelServiceStub,
        PredictionServiceStub,
    )
    from distributed_tf_serving_tpu_torch.proto import health as health_proto
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

    ch_s, ch_a = _channel(sync_port), _channel(aio_port)
    stub_s, stub_a = PredictionServiceStub(ch_s), PredictionServiceStub(ch_a)
    lat, sync_scores, res = {}, {}, {}
    try:
        for n, (ids, wts) in payloads.items():
            req = _request(ids, wts)
            stub_s.Predict(req, timeout=120)  # untimed first request per size
            ms = []
            for _ in range(AIO_REPEATS):
                t0 = time.perf_counter()
                scores = _scores_of(stub_s.Predict(req, timeout=120))
                ms.append((time.perf_counter() - t0) * 1e3)
                if n in sync_scores and not np.array_equal(scores, sync_scores[n]):
                    fail(f"aio: two sync answers to the same n={n} Predict differ")
                sync_scores[n] = scores
            lat[f"sync/{n}"] = _percentiles(ms)
        ids7, wts7 = payloads[7]
        sync_examples = {kind: _example_scores(kind, getattr(stub_s, kind.capitalize())(
            _examples_request(kind, ids7, wts7), timeout=60)) for kind in ("classify", "regress")}

        torch.cuda.synchronize()
        b0 = batcher.stats.batches
        ck.reset_launches()  # the aio path's counts: zeroed just before, read just after
        worst = 0.0
        for n, (ids, wts) in payloads.items():
            req = _request(ids, wts)
            stub_a.Predict(req, timeout=120)
            ms = []
            for _ in range(AIO_REPEATS):
                t0 = time.perf_counter()
                scores = _scores_of(stub_a.Predict(req, timeout=120))
                ms.append((time.perf_counter() - t0) * 1e3)
                if not np.array_equal(scores, sync_scores[n]):
                    fail(f"aio: n={n}: the aio answer is not bit-identical to the sync one "
                         f"(max |d| {np.max(np.abs(scores - sync_scores[n]))})")
            err = float(np.max(np.abs(scores - want[n])))
            worst = max(worst, err)
            if not np.all(np.isfinite(scores)) or err > APPLY_TOL:
                fail(f"aio: n={n}: max |dscore| vs the card's plain forward {err} > {APPLY_TOL}")
            lat[f"aio/{n}"] = _percentiles(ms)
            log(f"aio: n={n} p50 aio {lat[f'aio/{n}']['p50_ms']:.3f} / sync "
                f"{lat[f'sync/{n}']['p50_ms']:.3f} ms, p99 aio {lat[f'aio/{n}']['p99_ms']:.3f} / "
                f"sync {lat[f'sync/{n}']['p99_ms']:.3f} ms; bit-identical; max |d| {err:.3g} "
                f"({name})")
        for kind in ("classify", "regress"):
            req = _examples_request(kind, ids7, wts7)
            for _ in range(AIO_EXAMPLES):
                got = _example_scores(kind, getattr(stub_a, kind.capitalize())(req, timeout=60))
                if not np.array_equal(got, sync_examples[kind]):
                    fail(f"aio: {kind} answers differ from the sync server's")
            err = float(np.max(np.abs(got - want[7])))
            if err > APPLY_TOL:
                fail(f"aio: {kind}: max |dscore| vs the plain forward {err} > {APPLY_TOL}")
        res["examples_max_abs_err"] = err

        # PredictStream in chunks, response_arena on: each chunk kept as
        # received must carry the bits of a unary Predict of its rows (the
        # same bucket, so the same kernel variant and cluster size), and sit
        # within APPLY_TOL of the plain forward.
        n, chunk = AIO_STREAM
        ids, wts = payloads[n]
        t0 = time.perf_counter()
        chunks, arrivals = [], []
        for c in stub_a.PredictStream(_request(ids, wts), timeout=120,
                                      metadata=(("x-dts-stream-chunk", str(chunk)),)):
            chunks.append(c)
            arrivals.append((time.perf_counter() - t0) * 1e3)
        spans = sorted((c.offset, c.count) for c in chunks)
        if spans != [(o, chunk) for o in range(0, n, chunk)] or sum(c.final for c in chunks) != 1:
            fail(f"aio: PredictStream chunks {spans} (finals {sum(c.final for c in chunks)})")
        whole_bits = True
        whole_err = 0.0
        for c in chunks:
            got = _scores_of(c)
            sl = slice(c.offset, c.offset + c.count)
            unary = _scores_of(stub_a.Predict(_request(ids[sl], wts[sl]), timeout=120))
            if not np.array_equal(got, unary):
                fail(f"aio: stream chunk at {c.offset} is not bit-identical to the unary "
                     f"Predict of its rows (max |d| {np.max(np.abs(got - unary))})")
            if float(np.max(np.abs(got - want[n][sl]))) > APPLY_TOL:
                fail(f"aio: stream chunk at {c.offset} is off the plain forward")
            whole_bits &= bool(np.array_equal(got, sync_scores[n][sl]))
            whole_err = max(whole_err, float(np.max(np.abs(got - sync_scores[n][sl]))))
        res["stream"] = {"chunks": len(chunks), "first_chunk_ms": arrivals[0],
                         "last_chunk_ms": arrivals[-1],
                         "bits_of_the_n2048_unary": whole_bits,
                         "max_abs_vs_n2048_unary": whole_err}
        log(f"aio: PredictStream n={n} in {len(chunks)} chunks of {chunk} (response_arena on): "
            f"first {arrivals[0]:.3f} ms, last {arrivals[-1]:.3f} ms; every chunk bit-identical "
            f"to the unary Predict of its rows; against the n={n} unary answer: bit-identical "
            f"{whole_bits}, max |d| {whole_err:.3g} ({name})")

        meta = stub_a.GetModelMetadata(apis.GetModelMetadataRequest(
            model_spec=apis.ModelSpec(name="DCN")), timeout=30)
        status = ModelServiceStub(ch_a).GetModelStatus(apis.GetModelStatusRequest(
            model_spec=apis.ModelSpec(name="DCN")), timeout=30)
        health = HealthStub(ch_a).Check(HealthCheckRequest(service=""), timeout=30).status
        if (meta.model_spec.name, meta.model_spec.version.value) != ("DCN", 1) or \
                "signature_def" not in meta.metadata:
            fail(f"aio: GetModelMetadata answered {meta.model_spec}")
        if [(v.version, v.state) for v in status.model_version_status] != \
                [(1, apis.ModelVersionStatus.AVAILABLE)]:
            fail(f"aio: GetModelStatus answered {status}")
        if health != health_proto.SERVING:
            fail(f"aio: health answered {health}")
        torch.cuda.synchronize()
        launches = {f"{k}/{cd}": v for (k, cd), v in ck.launches.items()}
        batches = batcher.stats.batches - b0
    finally:
        ch_s.close()
        ch_a.close()
    fused = launches.get("fused_serve/bfloat16", 0) + launches.get("fused_serve_int8/bfloat16", 0)
    log(f"aio: launches on the aio path {launches} over {batches} batches; metadata, status "
        f"and health answered")
    if fused != batches:
        fail(f"aio: {batches} aio batches but {fused} fused serve launches: {launches}")
    # The requests fill every bucket, so each kernel the adopted decisions
    # route to launches and no other does. Which one wins a bucket is the
    # autotune's measurement (pallas_f32 and pallas_int8 are within noise of
    # each other): the breaker's stack, with no plane, holds the float kernel.
    decisions = batcher.kernels.snapshot()["decisions"]["DCN:1"]
    routed = {"fused_serve_int8/bfloat16" if d["quantized"] else "fused_serve/bfloat16"
              for d in decisions.values() if d["pallas"]}
    for key in ("fused_serve/bfloat16", "fused_serve_int8/bfloat16"):
        if (launches.get(key, 0) > 0) != (key in routed):
            fail(f"aio: the aio path launched {key} {launches.get(key, 0)} times ({launches}); "
                 f"the adopted decisions {decisions} route to {sorted(routed)}")
    res.update(latency=lat, max_abs_err=worst, launches=launches, batches=batches)
    return res


def _aio_breaker(name, batcher, port, payloads, want) -> dict:
    """The circuit breaker on the card: a batcher.dispatch wedge holds one
    Predict, one more queues behind it; once the breaker opens a new
    Predict must end UNAVAILABLE in under a second and the queued one with
    it; after clear() the wedged Predict and the next are answered. Then
    each error site ends its RPC with its code and the next RPC succeeds."""
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch import faults
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub

    ch = _channel(port)
    stub = PredictionServiceStub(ch)
    req, req7 = _request(*payloads[1000]), _request(*payloads[7])
    res = {}

    def check(scores, n, what):
        err = float(np.max(np.abs(scores - want[n])))
        if scores.shape != (n,) or not np.all(np.isfinite(scores)) or err > APPLY_TOL:
            fail(f"aio: breaker: {what}: max |dscore| {err} (shape {scores.shape})")

    launches0 = dict(ck.launches)  # the breaker stack's counts, read after its last RPC
    try:
        stub.Predict(req, timeout=60)
        # delay_s caps the wedge, should the run fail before clear().
        faults.get().add("batcher.dispatch", "wedge", count=1, delay_s=120.0)
        wedged = stub.Predict.future(req, timeout=120)
        _until_true(lambda: batcher._dispatching_since is not None, "the wedge did not start")
        queued = stub.Predict.future(req7, timeout=120)
        _until_true(lambda: bool(batcher._items or batcher._staged), "no Predict queued")

        def is_open():
            with batcher._cv:
                return batcher._wedged_for(time.perf_counter()) > 0

        open_t = _until_true(is_open, "the breaker did not open", timeout=AIO_BREAKER_S + 30)
        t0 = time.perf_counter()
        code = _rpc_code(lambda: stub.Predict(req7, timeout=30))
        refused_t = time.perf_counter()
        queued_code = _rpc_code(lambda: queued.result(timeout=30))
        if code != "UNAVAILABLE" or queued_code != "UNAVAILABLE":
            fail(f"aio: breaker open: a new Predict ended {code}, the queued one "
                 f"{queued_code} (want UNAVAILABLE both)")
        if refused_t - t0 >= 1.0:
            fail(f"aio: breaker open: the refusal took {refused_t - t0:.3f} s (limit 1 s)")
        clear_t = time.perf_counter()
        faults.get().clear()
        first = _scores_of(wedged.result(timeout=60))
        answered_t = time.perf_counter()
        check(first, 1000, "the wedged Predict")
        check(_scores_of(stub.Predict(req, timeout=60)), 1000, "the Predict after clear()")
        with batcher._cv:
            if batcher._wedged_for(time.perf_counter()):
                fail("aio: the breaker stayed open after the wedged batch completed")
        res.update(open_to_refusal_ms=(refused_t - open_t) * 1e3,
                   refusal_rpc_ms=(refused_t - t0) * 1e3,
                   clear_to_answer_ms=(answered_t - clear_t) * 1e3)
        log(f"aio: breaker ({AIO_BREAKER_S} s) open -> UNAVAILABLE answered "
            f"{res['open_to_refusal_ms']:.3f} ms (the RPC {res['refusal_rpc_ms']:.3f} ms), the "
            f"queued Predict UNAVAILABLE; clear() -> the wedged Predict answered "
            f"{res['clear_to_answer_ms']:.3f} ms; closed again ({name})")
        codes = {}
        for site, want_code in AIO_FAULTS:
            faults.get().add(site, "error", code=want_code, count=1)
            codes[site] = _rpc_code(lambda: stub.Predict(req7, timeout=30))
            faults.get().clear()
            if codes[site] != want_code:
                fail(f"aio: a {site}=error,code={want_code} rule ended the RPC {codes[site]}")
            check(_scores_of(stub.Predict(req7, timeout=30)), 7, f"the Predict after {site}")
        res["fault_codes"] = codes
        log(f"aio: injected faults ended their RPCs with {codes}; each next RPC answered")
        torch.cuda.synchronize()
        launches = {f"{k}/{cd}": v - launches0.get((k, cd), 0) for (k, cd), v in ck.launches.items()}
        others = {k: v for k, v in launches.items() if v and k != "fused_serve/bfloat16"}
        log(f"aio: launches on the breaker's aio server (no kernel plane) {launches}")
        if launches.get("fused_serve/bfloat16", 0) <= 0 or others:
            fail(f"aio: the breaker's aio server (the fused float kernel in every bucket) "
                 f"launched {launches}")
        res["launches"] = launches
    finally:
        faults.get().clear()
        ch.close()
    return res


def phase_aio(dev, name: str) -> dict:
    """The coroutine gRPC server (create_server_async), the encode arena and
    the batcher's failure paths on the card: configs/latency.toml with
    [kernels] enabled (the rest phase's table, adopted), seed-0 weights.
    Checks in the docstring of the module."""
    import dataclasses as dc

    import numpy as np

    from distributed_tf_serving_tpu_torch import faults
    from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server
    from distributed_tf_serving_tpu_torch.utils.config import (
        BatchingConfig,
        TransportConfig,
        load_config,
    )
    from distributed_tf_serving_tpu_torch.utils.tracing import request_trace

    loaded = load_config(os.path.join(HERE, "chiprun_out", "kernels_plane_rest.toml"))
    cfg, model_cfg, kc = loaded["server"], loaded["model"], loaded["kernels"]
    rng = np.random.RandomState(SEED + 6000)

    def payload(n):
        return (rng.randint(0, 1 << 40, size=(n, model_cfg.num_fields)).astype(np.int64),
                rng.rand(n, model_cfg.num_fields).astype(np.float32))

    payloads = {n: payload(n) for n in AIO_SIZES}
    res = {"card": name}
    add_aio, stop_aio = _aio_loop()
    batchers, sync_server = [], None
    try:
        impl, batcher, _ = build_stack(cfg, model_cfg, "cuda", seed=SEED, kernels_config=kc,
                                       transport_config=TransportConfig(response_arena=True))
        batchers.append(batcher)
        snap = batcher.kernels.snapshot()
        if snap["counters"]["table_reuses"] < 1:
            fail("aio: the stack did not adopt the rest phase's autotune table")
        decisions = snap["decisions"]["DCN:1"]
        want = _reference(dev, model_cfg, decisions, cfg.buckets, payloads)
        sync_server, sync_port = create_server(impl, "127.0.0.1:0")
        sync_server.start()
        aio_port = add_aio(impl)
        res["decisions"] = decisions
        res["serving"] = _aio_serving(name, batcher, aio_port, sync_port, payloads, want)

        total, n, client_counts = AIO_LOOP
        loop_payload = payload(n)
        res["closed_loop"] = {}
        for clients in client_counts:
            runs = []
            for label, port in (("sync", sync_port), ("aio", aio_port), ("aio", aio_port),
                                ("sync", sync_port)):
                r = _closed_loop_n(port, loop_payload, clients, total)
                runs.append({"server": label, **r})
                log(f"aio: closed loop {total} x n={n} at {clients} clients, {label}: p50 "
                    f"{r['p50_ms']:.3f} / p99 {r['p99_ms']:.3f} ms, {r['qps']:.1f} QPS ({name})")
            res["closed_loop"][clients] = runs
        sync_server.stop(0)
        sync_server = None

        # The breaker's stack: no kernel plane (the fused float kernel in
        # every bucket), its own aio server.
        impl2, batcher2, _ = build_stack(cfg, model_cfg, "cuda", seed=SEED)
        batchers.append(batcher2)
        batcher2.breaker_timeout_s = AIO_BREAKER_S
        port2 = add_aio(impl2)
        plain = {k: v for k, v in payloads.items() if k in (7, 1000)}
        res["breaker"] = _aio_breaker(name, batcher2, port2, payloads,
                                      _reference(dev, model_cfg, {}, cfg.buckets, plain))

        # The in-flight window: window 1 at depth 2 against the window-0
        # breaker stack (same weights, no plane), 4 clients.
        n, clients, per_client = AIO_WINDOW
        impl3, batcher3, _ = build_stack(
            cfg, model_cfg, "cuda", seed=SEED,
            batching_config=BatchingConfig(pipeline_depth=2, inflight_window=1))
        batchers.append(batcher3)
        port3 = add_aio(impl3)
        wp = [payload(n) for _ in range(clients)]
        base, base_qps = _answers(port2, wp, per_client)
        got, win_qps = _answers(port3, wp, per_client)
        for k, (g, b) in enumerate(zip(got, base)):
            if not np.array_equal(g, b):
                fail(f"aio: window 1: client {k}'s answer differs from the window-0 server's")
        ps = batcher3.pipeline_stats()
        res["window"] = {"inflight_peak": ps["inflight_peak"],
                         "inflight_window_waits": ps["inflight_window_waits"],
                         "qps": win_qps, "window0_qps": base_qps}
        log(f"aio: inflight_window 1 at depth 2, {clients} clients x {per_client} Predicts of "
            f"n={n}: inflight_peak {ps['inflight_peak']}, window waits "
            f"{ps['inflight_window_waits']}, {win_qps:.1f} QPS against {base_qps:.1f} at window "
            f"0; answers bit-identical ({name})")
        if ps["inflight_peak"] != 1 or ps["inflight_window_waits"] <= 0:
            fail(f"aio: window 1: inflight_peak {ps['inflight_peak']}, waits "
                 f"{ps['inflight_window_waits']}")
        for b in batchers[1:]:
            b.stop()
        del batchers[1:]

        # The pad buffer ring on dcn_v2 in f32, whose batches take the
        # batch.pad path (the native pack takes only the bf16 layout).
        f32 = dc.replace(model_cfg, compute_dtype="float32")
        _, ring_b, ring_sv = build_stack(cfg, f32, "cuda", seed=SEED,
                                         batching_config=BatchingConfig(buffer_ring=True))
        batchers.append(ring_b)
        _, plain_b, plain_sv = build_stack(cfg, f32, "cuda", seed=SEED)
        batchers.append(plain_b)
        arrays = {n: dict(zip(("feat_ids", "feat_wts"), payloads[n])) for n in AIO_RING_SIZES}
        if ring_b._fused_ctx(ring_sv, [arrays[7]]) is not None:
            fail("aio: ring: the f32 servable's batches do not take the batch.pad path")
        pad0 = request_trace.snapshot().get("batch.pad", {}).get("count", 0)
        for _ in range(AIO_RING_REPEATS):
            for n, a in arrays.items():
                got = ring_b.submit(ring_sv, a).result(timeout=60)["prediction_node"]
                ref = plain_b.submit(plain_sv, a).result(timeout=60)["prediction_node"]
                if not np.array_equal(got, ref):
                    fail(f"aio: ring: n={n} scores differ from the ring-off batcher's")
        pads = request_trace.snapshot()["batch.pad"]["count"] - pad0
        ring = ring_b.pipeline_stats()["buffer_ring"]
        res["ring"] = {**ring, "batch_pad_count": pads,
                       "batches": AIO_RING_REPEATS * len(arrays)}
        log(f"aio: buffer_ring on dcn_v2 f32: {ring} after {res['ring']['batches']} batches "
            f"(batch.pad count +{pads} over both batchers); scores bit-identical to ring off")
        if ring["reuses"] <= 0 or pads < 2 * res["ring"]["batches"]:
            fail(f"aio: ring: reuses {ring['reuses']}, batch.pad count +{pads}")
    finally:
        faults.get().clear()
        if sync_server is not None:
            sync_server.stop(0)
        stop_aio()
        for b in batchers:
            b.stop()
    return res


# The cache phase: the cache plane (cache/, the batcher's score cache, row
# cache, dedup and device input cache) at the width of configs/latency.toml.
CACHE_N = 1000  # candidates per Predict ([client] candidate_num of latency.toml)
CACHE_CATALOG = 4096  # distinct candidate rows of the zipfian catalog
CACHE_SKEW = 1.2  # P(row i) ∝ 1 / (i + 1) ** skew
CACHE_REPEATS = 5  # repeats of step 1's payload
CACHE_FLIGHT = (8, 60.0)  # single-flight: threads, the cap (s) on the leader's held dispatch
CACHE_HOT = 900  # B's rows taken from A; the rest of B's CACHE_N are fresh
CACHE_DEDUP = (2048, 200)  # dedup: rows of the request, distinct rows among them
# Input cache: repeats x n, distinct payloads of that n timed as misses,
# then distinct payloads x n to engage the bypass.
CACHE_INPUT = (20, 2048, 20, 70, 256)
CACHE_LOOP = (4, 250)  # zipfian closed loop: clients, Predicts each


def _spread(xs: list[float]) -> dict:
    """Median and extremes of a list of samples."""
    return {"n": len(xs), "median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def _spread_text(xs: list[float]) -> str:
    s = _spread(xs)
    return f"median {s['median']:.1f} [{s['min']:.1f}, {s['max']:.1f}] over {s['n']}"


def _zipf_loop(port: int, cat, idx, clients: int) -> dict:
    """The closed loop of the cache phase: client k sends requests k,
    k + clients, ... of `idx` (rows of the catalog `cat`), one at a time on
    its own channel: p50 / p99 / QPS over the wall. The same `idx` replays
    the same request stream for every server."""
    import threading

    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub

    lat, errors = [], []
    lock = threading.Lock()
    chans = [_channel(port) for _ in range(clients)]
    barrier = threading.Barrier(clients + 1)

    def client(k):
        stub = PredictionServiceStub(chans[k])
        mine = []
        barrier.wait(timeout=120)
        try:
            for i in range(k, len(idx), clients):
                req = _request(cat[0][idx[i]], cat[1][idx[i]])
                t0 = time.perf_counter()
                stub.Predict(req, timeout=120)
                mine.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
        with lock:
            lat.extend(mine)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    try:
        for t in threads:
            t.start()
        barrier.wait(timeout=120)
        t0 = time.perf_counter()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
    finally:
        for ch in chans:
            ch.close()
    if errors:
        fail(f"cache: the zipfian closed loop failed: {errors[0]!r}")
    return {**_percentiles(lat), "qps": len(lat) / wall, "requests": len(lat)}


def phase_cache(dev, name: str) -> dict:
    """The cache plane on the card: two stacks from build_stack on
    configs/latency.toml with [kernels] (the rest phase's table, adopted),
    one with [cache] enabled, dedup and row_granular, one without, each on
    a sync gRPC server. Checks in the docstring of the module."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch import codec, faults
    from distributed_tf_serving_tpu_torch.cache import canonical_rows
    from distributed_tf_serving_tpu_torch.cache.row_cache import digest_rows, row_structure_header
    from distributed_tf_serving_tpu_torch.models import Servable, ServableRegistry, build_model
    from distributed_tf_serving_tpu_torch.models.registry import model_signatures
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.ops.quantize import quantize_params
    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.serving.batcher import DynamicBatcher, bucket_for
    from distributed_tf_serving_tpu_torch.serving.server import (
        _make_watcher,
        build_stack,
        create_server,
        load_demo_servable,
    )
    from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable
    from distributed_tf_serving_tpu_torch.utils.config import load_config
    from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics
    from distributed_tf_serving_tpu_torch.utils.tracing import request_trace

    rest_toml = os.path.join(HERE, "chiprun_out", "kernels_plane_rest.toml")
    on_toml = os.path.join(HERE, "chiprun_out", "cache_on.toml")
    with open(rest_toml) as f:
        text = f.read()
    with open(on_toml, "w") as f:
        f.write(text + "\n[cache]\nenabled = true\ndedup = true\nrow_granular = true\n")
    off_loaded, on_loaded = load_config(rest_toml), load_config(on_toml)
    cfg, model_cfg, kc = off_loaded["server"], off_loaded["model"], off_loaded["kernels"]
    fields, vocab = model_cfg.num_fields, model_cfg.vocab_size
    rng = np.random.RandomState(SEED + 7000)

    def fresh(n):
        return (rng.randint(0, vocab, size=(n, fields)).astype(np.int64),
                rng.rand(n, fields).astype(np.float32))

    cat = fresh(CACHE_CATALOG)
    res = {"card": name}
    servers, chans, batchers, stop_rest = [], [], [], None
    base = tempfile.mkdtemp(prefix="dts_cache_")
    try:
        impl_on, on, _ = build_stack(cfg, model_cfg, "cuda", seed=SEED, kernels_config=kc,
                                     cache_config=on_loaded["cache"])
        batchers.append(on)
        impl_off, off, sv_off = build_stack(cfg, model_cfg, "cuda", seed=SEED, kernels_config=kc)
        batchers.append(off)
        if on.score_cache is None or on.row_cache is None or not on.dedup:
            fail("cache: [cache] enabled / dedup / row_granular did not arm the plane")
        if off.score_cache is not None or off.row_cache is not None or off.dedup:
            fail("cache: the cache-off stack armed a store")
        decisions = on.kernels.snapshot()["decisions"]["DCN:1"]
        for label, b in (("on", on), ("off", off)):
            snap = b.kernels.snapshot()
            if snap["counters"]["table_reuses"] < 1:
                fail(f"cache: the {label} stack did not adopt the rest phase's autotune table")
            if snap["decisions"]["DCN:1"] != decisions:
                fail(f"cache: the two stacks' decisions differ: {snap['decisions']}")
        res["decisions"] = decisions
        ports = {}
        for label, impl in (("on", impl_on), ("off", impl_off)):
            server, ports[label] = create_server(impl, "127.0.0.1:0")
            server.start()
            servers.append(server)
        stubs = {}
        for label, port in ports.items():
            chans.append(_channel(port))
            stubs[label] = PredictionServiceStub(chans[-1])

        def predict(label, ids, wts):
            t0 = time.perf_counter()
            resp = stubs[label].Predict(_request(ids, wts), timeout=120)
            got = codec.to_ndarray(resp.outputs["prediction_node"])
            if got.shape != (len(ids),) or not np.all(np.isfinite(got)):
                fail(f"cache: {label} answered shape {got.shape} for {len(ids)} rows")
            return got, (time.perf_counter() - t0) * 1e3

        plain_sv = load_demo_servable(ServableRegistry(), kind="dcn_v2", name="DCN", seed=SEED,
                                      config=model_cfg, device=dev)
        qparams = quantize_params(plain_sv.params)

        def plain(ids, wts, bucket, sv=None):
            """The card's plain forward (model.apply) on the tree the
            decision of `bucket` picked (v2, a hot-loaded version, serves the
            float baseline)."""
            params = plain_sv.params if sv is None else sv.params
            if sv is None and (decisions.get(str(bucket)) or {}).get("quantized"):
                params = qparams
            model = plain_sv.model if sv is None else sv.model
            with torch.inference_mode():
                return model.apply(params, {
                    "feat_ids": torch.from_numpy(ids).to(dev),
                    "feat_wts": torch.from_numpy(wts).to(dev)})["prediction_node"].float().cpu().numpy()

        def near(got, want, what):
            err = float(np.max(np.abs(got - want)))
            if err > APPLY_TOL:
                fail(f"cache: {what}: max |dscore| vs the plain forward {err} > {APPLY_TOL}")
            return err

        def counts(b):
            s = b.stats
            return {"batches": s.batches, "padded": s.padded_candidates,
                    "rows_executed": s.rows_executed, "rows_requested": s.rows_requested,
                    "row_full_hit_batches": s.row_full_hit_batches,
                    "dedup_rows_collapsed": s.dedup_rows_collapsed}

        def moved(c0, c1):
            return {k: c1[k] - c0[k] for k in c0}

        # The cache-off reference Predicts of steps 3 and 4 run inside the
        # launch window: their launches are counted apart and taken out.
        ref_launches: dict = {}

        def reference(ids, wts):
            l0 = dict(ck.launches)
            got = predict("off", ids, wts)[0]
            for k, v in ck.launches.items():
                ref_launches[k] = ref_launches.get(k, 0) + v - l0.get(k, 0)
            return got

        ck.reset_launches()
        # 1. Whole-request hits.
        p1 = fresh(CACHE_N)
        c0, h0 = counts(on), impl_on.cache_stats()["hits"]
        first, miss_ms = predict("on", *p1)
        c1 = counts(on)
        hit_ms = []
        for _ in range(CACHE_REPEATS):
            got, ms = predict("on", *p1)
            hit_ms.append(ms)
            if not np.array_equal(got, first):
                fail("cache: a whole-request hit differs from the answer that filled it")
        hits = impl_on.cache_stats()["hits"] - h0
        if c1["batches"] - c0["batches"] != 1 or counts(on)["batches"] != c1["batches"]:
            fail(f"cache: step 1 ran {counts(on)['batches'] - c0['batches']} batches, want 1")
        if hits < CACHE_REPEATS:
            fail(f"cache: {hits} whole-request hits for {CACHE_REPEATS} repeats")
        res["request_hits"] = {"miss_ms": miss_ms, "hit_p50_ms": statistics.median(hit_ms),
                               "hits": hits,
                               "max_abs_err": near(first, plain(*p1, bucket_for(CACHE_N, cfg.buckets)),
                                                   "step 1")}
        log(f"cache: {CACHE_REPEATS} repeats of an n={CACHE_N} Predict: {hits} hits, no batch, "
            f"bit-identical; miss {miss_ms:.3f} ms, hit p50 {res['request_hits']['hit_p50_ms']:.3f} "
            f"ms over gRPC ({name})")

        # 2. Single-flight: the leader's dispatch held (a wedge) until all
        # 8 callers have joined its flight, then released: the flight's
        # window does not depend on how fast 8 encodes run under one GIL.
        threads_n, cap = CACHE_FLIGHT
        p2 = fresh(CACHE_N)
        c0, co0 = counts(on), impl_on.cache_stats()["coalesced"]
        faults.get().add("batcher.dispatch", "wedge", delay_s=cap, count=1)
        answers = [None] * threads_n
        barrier = threading.Barrier(threads_n)

        def caller(k):
            barrier.wait(timeout=60)
            answers[k] = predict("on", *p2)[0]

        ths = [threading.Thread(target=caller, args=(k,)) for k in range(threads_n)]
        for t in ths:
            t.start()
        t_hold = time.perf_counter()
        while (impl_on.cache_stats()["coalesced"] - co0 < threads_n - 1
               and time.perf_counter() - t_hold < cap):
            time.sleep(0.005)
        held_s = time.perf_counter() - t_hold
        faults.get().clear()  # releases the held dispatch
        for t in ths:
            t.join(120)
        coalesced = impl_on.cache_stats()["coalesced"] - co0
        ran = counts(on)["batches"] - c0["batches"]
        if any(a is None for a in answers) or any(not np.array_equal(a, answers[0])
                                                  for a in answers):
            fail("cache: the single-flight callers' answers differ or are missing")
        if ran != 1 or coalesced < threads_n - 1:
            fail(f"cache: single-flight ran {ran} batches with {coalesced} coalesced "
                 f"for {threads_n} callers")
        res["single_flight"] = {"callers": threads_n, "batches": ran, "coalesced": coalesced,
                                "held_s": held_s}
        log(f"cache: single-flight: {threads_n} identical Predicts, the leader's dispatch held "
            f"{held_s:.3f} s until all joined, ran {ran} batch, {coalesced} coalesced, answers "
            f"bit-identical")

        # 3. The row tier: A (1000 catalog rows), then B (A's first 900 and
        # 100 fresh rows), then B reversed (a full row hit).
        a_idx = rng.choice(CACHE_CATALOG, CACHE_N, replace=False)
        a = (cat[0][a_idx], cat[1][a_idx])
        ra, _ = predict("on", *a)
        cold = fresh(CACHE_N - CACHE_HOT)
        b = (np.concatenate([a[0][:CACHE_HOT], cold[0]]), np.concatenate([a[1][:CACHE_HOT], cold[1]]))
        c0 = counts(on)
        rb, _ = predict("on", *b)
        d = moved(c0, counts(on))
        cold_bucket = bucket_for(CACHE_N - CACHE_HOT, cfg.buckets)
        if (d["rows_executed"], d["padded"], d["batches"]) != (CACHE_N - CACHE_HOT, cold_bucket, 1):
            fail(f"cache: B executed {d} (want {CACHE_N - CACHE_HOT} rows in bucket {cold_bucket})")
        if not np.array_equal(rb[:CACHE_HOT], ra[:CACHE_HOT]):
            fail("cache: B's hot rows differ from A's answer rows")
        rcold = reference(*cold)
        if not np.array_equal(rb[CACHE_HOT:], rcold):
            fail(f"cache: B's cold rows differ from the cache-off server's answer at bucket "
                 f"{cold_bucket} (max |d| {np.max(np.abs(rb[CACHE_HOT:] - rcold))})")
        big = bucket_for(CACHE_N, cfg.buckets)
        err_b = max(near(rb[:CACHE_HOT], plain(*a, big)[:CACHE_HOT], "B's hot rows"),
                    near(rb[CACHE_HOT:], plain(*cold, cold_bucket), "B's cold rows"))
        launches0 = dict(ck.launches)
        c0 = counts(on)
        rrev, _ = predict("on", b[0][::-1].copy(), b[1][::-1].copy())
        d_full = moved(c0, counts(on))
        if not np.array_equal(rrev, rb[::-1]):
            fail("cache: the full row hit differs from B's answer")
        if d_full["row_full_hit_batches"] != 1 or d_full["batches"] or dict(ck.launches) != launches0:
            fail(f"cache: the full row hit moved {d_full} / launched "
                 f"{ {k: v - launches0[k] for k, v in ck.launches.items() if v != launches0[k]} }")
        res["rows"] = {"b": d, "full_hit": d_full, "max_abs_err": err_b, "cold_bucket": cold_bucket}
        log(f"cache: row tier: B = {CACHE_HOT} rows of A + {CACHE_N - CACHE_HOT} fresh executed "
            f"{d['rows_executed']} rows in bucket {cold_bucket}; hot rows = A's bits, cold rows = "
            f"the cache-off server's bits at bucket {cold_bucket}; within {err_b:.3g} of the plain "
            f"forward; B reversed: a full row hit, no batch, no launch")

        # 4. Dedup: 2048 rows over 200 fresh distinct rows.
        rows, distinct = CACHE_DEDUP
        u = fresh(distinct)
        sel = np.concatenate([np.arange(distinct), rng.randint(0, distinct, rows - distinct)])
        rng.shuffle(sel)
        dd = (u[0][sel], u[1][sel])
        c0 = counts(on)
        rd, _ = predict("on", *dd)
        d = moved(c0, counts(on))
        dedup_bucket = bucket_for(distinct, cfg.buckets)
        if (d["dedup_rows_collapsed"], d["rows_executed"], d["padded"]) != (
                rows - distinct, distinct, dedup_bucket):
            fail(f"cache: the dedup request moved {d} (want {rows - distinct} collapsed, "
                 f"{distinct} executed in bucket {dedup_bucket})")
        # The batch runs its distinct rows in the order of their digests.
        arrays = {"feat_ids": dd[0], "feat_wts": dd[1]}
        digs = digest_rows(canonical_rows(arrays), row_structure_header(arrays))
        _, first_idx, inverse = np.unique(
            np.frombuffer(b"".join(digs), np.uint8).reshape(rows, 16), axis=0,
            return_index=True, return_inverse=True)
        runiq = reference(dd[0][first_idx], dd[1][first_idx])
        if not np.array_equal(rd, runiq[inverse.reshape(-1)]):
            fail("cache: the deduplicated answer differs from the cache-off server's answer on "
                 "the distinct rows, scattered back")
        err_d = near(rd, plain(dd[0][first_idx], dd[1][first_idx],
                               dedup_bucket)[inverse.reshape(-1)], "dedup")
        res["dedup"] = {**d, "bucket": dedup_bucket, "max_abs_err": err_d}
        log(f"cache: dedup: {rows} rows over {distinct} distinct collapsed {d['dedup_rows_collapsed']} "
            f"and ran bucket {dedup_bucket}; bits of the cache-off server's answer on the distinct "
            f"rows, scattered back")
        res["launches"] = {f"{k}/{cd}": v - ref_launches.get((k, cd), 0)
                           for (k, cd), v in ck.launches.items()}
        res["reference_launches"] = {f"{k}/{cd}": v for (k, cd), v in ref_launches.items()}
        want_ref = sum(1 for n in (CACHE_N - CACHE_HOT, distinct)
                       if (decisions.get(str(bucket_for(n, cfg.buckets))) or {}).get("pallas"))
        if sum(ref_launches.values()) != want_ref:
            fail(f"cache: the two cache-off reference Predicts launched {ref_launches}, "
                 f"want {want_ref}")
        used = {str(bucket_for(n, cfg.buckets)) for n in (CACHE_N, CACHE_N - CACHE_HOT, distinct)}
        picked = {bk: decisions.get(bk) or {} for bk in used}
        want = {"fused_serve_int8" if dec.get("quantized") else "fused_serve"
                for dec in picked.values() if dec.get("pallas")}
        for kname in sorted(want):
            if res["launches"].get(f"{kname}/bfloat16", 0) <= 0:
                fail(f"cache: {kname}/bfloat16 did not launch in steps 1-4 "
                     f"(decisions {decisions}, launches {res['launches']})")
        log(f"cache: kernel launches of the cache-on stack over steps 1-4 {res['launches']} "
            f"(the cache-off reference Predicts' {res['reference_launches']} taken out; decisions at the "
            f"buckets used: {dict(sorted(picked.items(), key=lambda kv: int(kv[0])))})")

        # 6. The device input cache, on the cache-off stack.
        reps, n_big, misses_n, distinct_n, n_small = CACHE_INPUT
        p6 = fresh(n_big)
        ic = off.input_cache

        def timed(ids, wts):
            """One cache-off Predict and its batch's `batch.cache` span (us)."""
            ph0 = request_trace.snapshot().get("batch.cache", {"total_ms": 0.0, "count": 0})
            got = predict("off", ids, wts)[0]
            ph1 = request_trace.snapshot().get("batch.cache", {"total_ms": 0.0, "count": 0})
            if ph1["count"] - ph0["count"] != 1:
                fail(f"cache: a cache-off n={len(ids)} Predict timed "
                     f"{ph1['count'] - ph0['count']} batch.cache spans, want 1")
            return got, (ph1["total_ms"] - ph0["total_ms"]) * 1e3

        s0, i0 = counts(off), (ic.hits, ic.misses, off.stats.h2d_copies)
        first6, miss0 = timed(*p6)
        hit_us = []
        for _ in range(reps - 1):
            got, us = timed(*p6)
            hit_us.append(us)
            if not np.array_equal(got, first6):
                fail("cache: an input-cache hit answered other bits than its miss")
        ihits = ic.hits - i0[0]
        copies = off.stats.h2d_copies - i0[2]
        nb = counts(off)["batches"] - s0["batches"]
        if ihits < reps - 1 or copies + ihits != nb:
            fail(f"cache: input cache: {ihits} hits, {copies} copies for {nb} batches")
        # Misses: distinct n_big payloads, one batch.cache span each (the
        # probe window stays above min_hit_rate, so none is bypassed).
        m0 = ic.misses
        miss_us = [miss0] + [timed(*fresh(n_big))[1] for _ in range(misses_n)]
        if ic.misses - m0 != misses_n:
            fail(f"cache: {misses_n} distinct n={n_big} payloads made {ic.misses - m0} misses")
        ic.rearm()
        cycles0 = ic.bypass_cycles
        for _ in range(distinct_n):
            predict("off", *fresh(n_small))
        if ic.bypass_cycles - cycles0 < 1 or ic._lru:
            fail(f"cache: {distinct_n} distinct payloads: bypass cycles "
                 f"{ic.bypass_cycles - cycles0}, {len(ic._lru)} entries left")
        # The pack and the copy the cache saves, on a batcher without it.
        nb_ = DynamicBatcher(buckets=cfg.buckets, max_wait_us=0, device="cuda",
                             input_cache_entries=0)
        entry = nb_.step_for(sv_off)
        ctx = nb_._fused_ctx(sv_off, [{"feat_ids": p6[0], "feat_wts": p6[1]}])
        pack_ms, issue_ms, done_ms = [], [], []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            buf, _layout = nb_._pack(entry, ctx, n_big)
            t1 = time.perf_counter()
            dbuf, event = nb_._upload(buf)
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            nb_.ring.release([buf], event)
            pack_ms.append((t1 - t0) * 1e3)
            issue_ms.append((t2 - t1) * 1e3)
            done_ms.append((t3 - t1) * 1e3)
        nb_ = entry = dbuf = None
        res["input_cache"] = {
            "hits": ihits, "h2d_copies": copies, "batches": nb,
            "batch_cache_miss_us": _spread(miss_us), "batch_cache_hit_us": _spread(hit_us),
            "uncached_fusedpack_ms": statistics.median(pack_ms),
            "uncached_h2d_issue_ms": statistics.median(issue_ms),
            "uncached_h2d_done_ms": statistics.median(done_ms),
            "bypass_cycles": ic.bypass_cycles - cycles0}
        log(f"cache: input cache: {reps} x n={n_big}: {ihits} hits, {copies} copies, {nb} batches, "
            f"bit-identical; batch.cache on a hit {_spread_text(hit_us)} us, on a miss "
            f"{_spread_text(miss_us)} us (pack + upload issue inside); without the cache: fusedpack "
            f"{res['input_cache']['uncached_fusedpack_ms'] * 1e3:.1f} us + H2D issue "
            f"{res['input_cache']['uncached_h2d_issue_ms'] * 1e3:.1f} us "
            f"(copy done {res['input_cache']['uncached_h2d_done_ms'] * 1e3:.1f} us); then "
            f"{distinct_n} distinct n={n_small}: bypass engaged, store empty ({name})")

        # 7. The zipfian closed loop, cache off / on / on / off.
        clients, per_client = CACHE_LOOP
        p = np.arange(1, CACHE_CATALOG + 1, dtype=np.float64) ** -CACHE_SKEW
        idx = rng.choice(CACHE_CATALOG, size=(clients * per_client, CACHE_N), p=p / p.sum())
        runs = []
        for label in ("off", "on", "on", "off"):
            b = on if label == "on" else off
            if label == "on":
                # Each run replays the same stream from empty stores: the
                # second is a repeat of the first, not a run of hits.
                impl_on.cache_flush()
            c0 = counts(b)
            sc0 = impl_on.cache_stats() if label == "on" else None
            rc0 = impl_on.row_cache_stats() if label == "on" else None
            r = _zipf_loop(ports[label], cat, idx, clients)
            d = moved(c0, counts(b))
            r.update(server=label, batches=d["batches"])
            if label == "on":
                sc1, rc1 = impl_on.cache_stats(), impl_on.row_cache_stats()
                looked = (sc1["hits"] + sc1["misses"]) - (sc0["hits"] + sc0["misses"])
                rlooked = (rc1["hits"] + rc1["misses"]) - (rc0["hits"] + rc0["misses"])
                r["request_hit_rate"] = (sc1["hits"] - sc0["hits"]) / max(looked, 1)
                r["row_hit_rate"] = (rc1["hits"] - rc0["hits"]) / max(rlooked, 1)
                r["rows_executed_fraction"] = d["rows_executed"] / max(d["rows_requested"], 1)
            runs.append(r)
            extra = (f", request hit rate {r['request_hit_rate']:.4f}, row hit rate "
                     f"{r['row_hit_rate']:.4f}, rows executed / requested "
                     f"{r['rows_executed_fraction']:.4f}" if label == "on" else "")
            log(f"cache: zipfian closed loop ({CACHE_CATALOG} rows, skew {CACHE_SKEW}) "
                f"{clients} x {per_client} Predicts of n={CACHE_N}, cache {label}: p50 "
                f"{r['p50_ms']:.3f} / p99 {r['p99_ms']:.3f} ms, {r['qps']:.1f} QPS, "
                f"{r['batches']} batches{extra} ({name})")
        res["zipf_loop"] = runs

        # 5. Invalidation: version 2 through the server's watcher and its
        # hook (after the loop, which compares both stacks on version 1).
        again, _ = predict("on", *p1)
        if not np.array_equal(again, first):
            fail("cache: step 1's payload no longer answers its first bits before the swap")
        model = build_model("dcn_v2", dataclasses.replace(model_cfg, name="DCN"))
        sv2 = Servable(name="DCN", version=2, model=model, params=model.init(SEED + 1, dev),
                       signatures=model_signatures(model))
        save_servable(os.path.join(base, "2"), sv2, "dcn_v2")
        inval0 = impl_on.cache_stats()["invalidations"]
        watcher = _make_watcher(base, "DCN", (), cfg, impl_on.registry, on)
        watcher.poll_once()
        if 2 not in impl_on.registry.models().get("DCN", []):
            fail(f"cache: the watcher did not load version 2: {impl_on.registry.models()}")
        inval = impl_on.cache_stats()["invalidations"] - inval0
        c0 = counts(on)
        v2, _ = predict("on", *p1)
        ran = counts(on)["batches"] - c0["batches"]
        err_v2 = near(v2, plain(*p1, big, sv=sv2), "version 2")
        if inval <= 0 or ran != 1 or np.array_equal(v2, first):
            fail(f"cache: the swap invalidated {inval} entries and the repeat ran {ran} batches "
                 f"(answer {'unchanged' if np.array_equal(v2, first) else 'changed'})")
        res["invalidation"] = {"invalidations": inval, "batches": ran, "max_abs_err": err_v2}
        log(f"cache: version 2 loaded through the server's watcher: {inval} entries invalidated, "
            f"the repeat of step 1 ran {ran} batch and answers version 2 (within {err_v2:.3g})")

        # 8. Telemetry: the REST gateway in process on the cache-on stack.
        port, stop_rest = _rest_in_process(impl_on, ServerMetrics())
        http = _Http(port)
        try:
            cz = http.json("GET", "/cachez")
            want_cz = json.loads(json.dumps(impl_on.cache_stats()))
            want_cz["row_cache"] = json.loads(json.dumps(impl_on.row_cache_stats()))
            if cz != want_cz:
                fail(f"cache: /cachez differs from cache_stats() / row_cache_stats(): "
                     f"{ {k: (cz.get(k), want_cz.get(k)) for k in want_cz if cz.get(k) != want_cz.get(k)} }")
            status, data = http.call("GET", "/monitoring/prometheus/metrics")
            prom = data.decode()
            line = next((ln for ln in prom.splitlines()
                         if ln.startswith("dts_tpu_cache_hits_total ")), None)
            if status != 200 or line is None or int(line.split()[1]) != want_cz["hits"]:
                fail(f"cache: dts_tpu_cache_hits_total {line!r}, snapshot {want_cz['hits']}")
            row_lines = sum(1 for ln in prom.splitlines() if ln.startswith("dts_tpu_cache_row"))
            entries = impl_on.cache_stats()["entries"] + impl_on.row_cache_stats()["entries"]
            fl = http.json("POST", "/cachez/flush")
            if fl != {"flushed": True, "entries_dropped": entries} or entries <= 0:
                fail(f"cache: POST /cachez/flush answered {fl}, {entries} entries held")
            m0 = impl_on.cache_stats()["misses"]
            predict("on", *p1)
            if impl_on.cache_stats()["misses"] != m0 + 1:
                fail("cache: the repeat after the flush did not miss")
        finally:
            http.close()
            stop_rest()
            stop_rest = None
        res["telemetry"] = {"cachez_hits": want_cz["hits"], "row_series": row_lines,
                            "flushed": fl["entries_dropped"]}
        log(f"cache: /cachez = cache_stats() + row_cache_stats(); dts_tpu_cache_hits_total "
            f"{want_cz['hits']}, {row_lines} dts_tpu_cache_row* lines; flush dropped "
            f"{fl['entries_dropped']} entries and the next repeat missed")
    finally:
        faults.get().clear()
        if stop_rest is not None:
            stop_rest()
        for ch in chans:
            ch.close()
        for server in servers:
            server.stop(0)
        for b in batchers:
            b.stop()
        shutil.rmtree(base, ignore_errors=True)
    return res


INTEGRITY_STACKS = (  # label, compute dtype, use_pallas_cross, variants (name, decision, kernel)
    ("plane_bf16", "bfloat16", False, (("float", (False, True), "fused_serve"),
                                       ("int8", (True, True), "fused_serve_int8"))),
    ("plane_f32", "float32", False, (("float", (False, True), "fused_serve"),
                                     ("int8", (True, True), "fused_serve_int8"))),
    ("cross_bf16", "bfloat16", True, (("float", None, "fused_cross_apply"),)),
    ("cross_f32", "float32", True, (("float", None, "fused_cross_apply"),)),
)
INTEGRITY_PAIR = 500  # candidates of each request of the coalesced score_nan pair
INTEGRITY_DECODE = (2048, 10)  # predict.decode with / without a stamp: candidates, Predicts per run
INTEGRITY_LOOP = (4, 250, 1000)  # cost loop: clients, Predicts each, candidates


def _force_variant(batcher, servable, decision) -> None:
    """Pin every bucket's kernel-plane decision to `decision` = (quantized,
    fused) for `servable`, with no autotune: the live path then routes each
    batch, and its shadow, through that kernel. The decisions dict is
    replaced whole, as the plane's fast path expects."""
    import weakref

    km = batcher.kernels
    km._decisions = {**km._decisions, (servable.name, servable.version): (
        weakref.ref(servable), {int(b): decision for b in batcher.buckets})}


def _scores(batcher, servable, ids, wts):
    return batcher.submit(servable, {"feat_ids": ids, "feat_wts": wts},
                          output_keys=("prediction_node",)).result(120)["prediction_node"]


def _launch_counts() -> dict:
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck

    return {f"{k}/{cd}": n for (k, cd), n in ck.launches.items()}


def _md(call_or_err) -> dict:
    try:
        return dict(call_or_err.trailing_metadata() or ())
    except Exception:  # noqa: BLE001 — no metadata
        return {}


def phase_integrity(dev, name: str) -> dict:
    """The integrity plane on the card (serving/integrity.py and its
    wiring): the determinism of every (kernel, dtype) at every bucket under
    shadow_fraction 1.0, the keyed readback_bitflip and score_nan faults,
    the wire CRC over gRPC, the REST surfaces, and the shadow's cost.
    Checks in the docstring of the module."""
    import threading

    import grpc
    import numpy as np

    from distributed_tf_serving_tpu_torch import codec, faults
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.serving.batcher import poison_fault_key, prepare_inputs
    from distributed_tf_serving_tpu_torch.serving.integrity import IntegrityScreenError
    from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server
    from distributed_tf_serving_tpu_torch.serving.service import PredictionServiceImpl, ServiceError
    from distributed_tf_serving_tpu_torch.utils.config import (
        IntegrityConfig,
        KernelsConfig,
        load_config,
    )
    from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics
    from distributed_tf_serving_tpu_torch.utils.tracing import request_trace

    loaded = load_config(os.path.join(HERE, "configs", "latency.toml"))
    cfg, model_cfg = loaded["server"], loaded["model"]
    fields = model_cfg.num_fields
    # The kernel plane with no autotune: the phase pins each bucket's
    # decision itself, so every variant runs at every bucket.
    kc = KernelsConfig(enabled=True, autotune=False, table_file="")
    ic = IntegrityConfig(enabled=True, shadow_fraction=1.0)
    rng = np.random.RandomState(SEED + 14)

    def payload(n):
        return (rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
                rng.rand(n, fields).astype(np.float32))

    out: dict = {"card": name}
    stacks, servers, stubs = {}, [], []
    try:
        for label, cd, cross, variants in INTEGRITY_STACKS:
            mc = dataclasses.replace(model_cfg, compute_dtype=cd, use_pallas_cross=cross)
            impl, batcher, sv = build_stack(cfg, mc, "cuda", seed=SEED, fused_kernel=not cross,
                                            kernels_config=None if cross else kc,
                                            integrity_config=ic)
            stacks[label] = (impl, batcher, sv, variants, cd)
        bucket_payloads = {b: payload(b) for b in BUCKETS}  # n = b fills bucket b alone

        # (a) Determinism. The references first, each stack's own answer with
        # the plane detached (counted apart from the shadowed run).
        refs = {}
        for label, (impl, batcher, sv, variants, cd) in stacks.items():
            plane, batcher.integrity = batcher.integrity, None
            for vname, decision, _ in variants:
                if decision is not None:
                    _force_variant(batcher, sv, decision)
                for b, (ids, wts) in bucket_payloads.items():
                    refs[label, vname, b] = _scores(batcher, sv, ids, wts)
            batcher.integrity = plane
        before = {label: (s[1].stats.batches, s[1].integrity.snapshot()["shadow"],
                          s[1].stats.shadow_input_cache_hits) for label, s in stacks.items()}
        primaries: dict = {}
        ck.reset_launches()
        for label, (impl, batcher, sv, variants, cd) in stacks.items():
            for vname, decision, kname in variants:
                if decision is not None:
                    _force_variant(batcher, sv, decision)
                for b, (ids, wts) in bucket_payloads.items():
                    got = _scores(batcher, sv, ids, wts)
                    if not np.array_equal(got, refs[label, vname, b]):
                        fail(f"integrity: {label} {vname} bucket {b}: the shadowed answer is not "
                             "the bits of the plane-off answer")
                    key = f"{kname}/{cd}"
                    primaries[key] = primaries.get(key, 0) + 1
        launches = _launch_counts()
        out["launches"] = launches
        out["primary_batches"] = primaries
        for key, n in primaries.items():
            if launches[key] != 2 * n:
                fail(f"integrity: {key} launched {launches[key]} times for {n} primary batches "
                     f"(want {2 * n}: each batch and its shadow); counts {launches}")
        determinism = {}
        for label, (impl, batcher, sv, variants, cd) in stacks.items():
            b0, sh0, hits0 = before[label]
            sh = batcher.integrity.snapshot()["shadow"]
            batches = batcher.stats.batches - b0
            shadows = sh["batches"] - sh0["batches"]
            mism = sh["mismatches"] - sh0["mismatches"]
            if mism or shadows != batches or batches != len(variants) * len(BUCKETS):
                fail(f"integrity: {label}: {batches} batches, {shadows} shadow batches, "
                     f"{mism} mismatches (want {len(variants) * len(BUCKETS)}, equal, 0)")
            determinism[label] = {"batches": batches, "shadow_batches": shadows,
                                  "mismatches": mism,
                                  "shadow_input_cache_hits":
                                      batcher.stats.shadow_input_cache_hits - hits0}
            log(f"integrity: {label} ({', '.join(v for v, _, _ in variants)}) at buckets "
                f"{list(BUCKETS)}: {batches} batches, {shadows} shadows, 0 mismatches, answers "
                f"= the plane-off bits; shadow input-cache hits "
                f"{determinism[label]['shadow_input_cache_hits']} ({name})")
        out["determinism"] = determinism
        log(f"integrity: launches over the shadowed run {launches} (2 x {primaries})")

        impl, batcher, sv, _, _ = stacks["plane_bf16"]
        plane = batcher.integrity
        _force_variant(batcher, sv, (False, True))

        # (b) readback_bitflip keyed on one payload: its batch fails
        # UNAVAILABLE through the shadow compare; clean shadows clear suspect.
        ids, wts = payload(1000)
        faults.get().add("readback_bitflip", "error", count=1, key=poison_fault_key(
            prepare_inputs({"feat_ids": ids, "feat_wts": wts})))
        s0 = plane.snapshot()
        try:
            impl.predict(_request(ids, wts), deadline_s=60)
            fail("integrity: the bitflip-keyed Predict answered")
        except ServiceError as e:
            if e.code != "UNAVAILABLE" or "shadow verification mismatch" not in str(e):
                fail(f"integrity: the bitflip-keyed Predict failed {e.code}: {e}")
        finally:
            faults.get().clear()
        s1 = plane.snapshot()
        if (s1["shadow"]["mismatches"] - s0["shadow"]["mismatches"] != 1
                or s1["escalations"] - s0["escalations"] != 1 or not s1["suspect"]):
            fail(f"integrity: after the bitflip: {s1}")
        for _ in range(ic.suspect_clear_passes):
            _scores(batcher, sv, *payload(256))
        if plane.snapshot()["suspect"]:
            fail("integrity: suspect_clear_passes clean shadows did not clear the suspect state")
        out["bitflip"] = {"mismatches": 1, "escalations": 1, "suspect_cleared_after":
                          ic.suspect_clear_passes}
        log(f"integrity: readback_bitflip -> UNAVAILABLE, 1 mismatch, 1 escalation, suspect "
            f"cleared by {ic.suspect_clear_passes} clean shadows")

        # (c) score_nan keyed on one request of a coalesced pair (shadowing
        # off: the shadow compare would catch the NaN first).
        plane.config = dataclasses.replace(plane.config, shadow_fraction=0.0)
        batcher.max_wait_s = 0.05  # the pair coalesces
        pair = [payload(INTEGRITY_PAIR), payload(INTEGRITY_PAIR)]

        def submit_pair():
            b0 = batcher.stats.batches
            futs = [batcher.submit(sv, {"feat_ids": i, "feat_wts": w},
                                   output_keys=("prediction_node",)) for i, w in pair]
            for f in futs:
                try:
                    f.result(60)
                except Exception:  # noqa: BLE001 — read below
                    pass
            if batcher.stats.batches - b0 != 1:
                fail(f"integrity: the score_nan pair ran {batcher.stats.batches - b0} batches")
            return futs

        clean = [f.result()["prediction_node"] for f in submit_pair()]
        trips0 = plane.snapshot()["screen"]["trips"]
        faults.get().add("score_nan", "error", key=poison_fault_key(
            prepare_inputs({"feat_ids": pair[1][0], "feat_wts": pair[1][1]})))
        try:
            a, b = submit_pair()
        finally:
            faults.get().clear()
        exc = b.exception()
        if not isinstance(exc, IntegrityScreenError) or \
                PredictionServiceImpl._translate_batcher_error(exc, b).code != "UNAVAILABLE":
            fail(f"integrity: the NaN-keyed request ended {exc!r}")
        if a.exception() is not None or not np.array_equal(a.result()["prediction_node"],
                                                           clean[0]):
            fail("integrity: the NaN-keyed request's batchmate lost its fault-free bits")
        trips = plane.snapshot()["screen"]["trips"] - trips0
        if trips != 1:
            fail(f"integrity: screen.trips moved {trips}")
        batcher.max_wait_s = cfg.max_wait_us / 1e6
        out["score_nan"] = {"trips": trips}
        log("integrity: score_nan -> the keyed request UNAVAILABLE, its batchmate the "
            "fault-free bits, screen.trips +1")

        # (d) The wire CRC over gRPC, stamped with the port's own codec.
        server, port = create_server(impl, "127.0.0.1:0")
        server.start()
        servers.append(server)
        ch = _channel(port)
        stubs.append(ch)
        stub = PredictionServiceStub(ch)
        ids, wts = payload(INTEGRITY_DECODE[0])
        req = _request(ids, wts)
        stamp = codec.crc_sidecar({"feat_ids": ids, "feat_wts": wts})
        w0 = plane.snapshot()["wire"]
        resp, call = stub.Predict.with_call(req, timeout=60,
                                            metadata=((codec.CRC_INPUT_MD, stamp),))
        sidecar = _md(call).get(codec.CRC_SCORE_MD)
        decoded = {k: codec.to_ndarray(v) for k, v in resp.outputs.items()}
        if not sidecar or codec.verify_crc_sidecar(decoded, sidecar):
            fail(f"integrity: response stamp {sidecar!r} does not verify")
        head, _, hexcrc = stamp.partition(",")[0].partition("=")
        bad = stamp.replace(f"{head}={hexcrc}",
                            f"{head}={hexcrc[:-1]}{'0' if hexcrc[-1] != '0' else '1'}")
        res = {}

        def send(tag, md):
            try:
                r, c = stub.Predict.with_call(_request(ids, wts), timeout=60, metadata=md)
                res[tag] = ("OK", r, _md(c))
            except grpc.RpcError as e:
                res[tag] = (e.code().name, e.details(), _md(e))

        threads = [threading.Thread(target=send, args=("bad", ((codec.CRC_INPUT_MD, bad),))),
                   threading.Thread(target=send, args=("clean", ((codec.CRC_INPUT_MD, stamp),)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        if res.get("bad", ("?",))[0] != "INVALID_ARGUMENT" or "corrupt-wire" not in res["bad"][1]:
            fail(f"integrity: the wrong-stamp Predict ended {res.get('bad')}")
        if res.get("clean", ("?",))[0] != "OK":
            fail(f"integrity: the concurrent clean Predict ended {res.get('clean')}")
        for tag in ("clean",):
            r, md = res[tag][1], res[tag][2]
            dec = {k: codec.to_ndarray(v) for k, v in r.outputs.items()}
            if codec.verify_crc_sidecar(dec, md.get(codec.CRC_SCORE_MD, "x=0")):
                fail("integrity: a response's x-dts-score-crc does not verify")
        w1 = plane.snapshot()["wire"]
        if (w1["inputs_verified"] - w0["inputs_verified"] != 2
                or w1["inputs_rejected"] - w0["inputs_rejected"] != 1):
            fail(f"integrity: wire counters {w0} -> {w1}")
        # A bf16 feat_wts, stamped as its sender checksums it: the bits on
        # the wire under numpy's bfloat16 header ("<V2"), computed here with
        # crc32c directly. It answers OK, with the bits of the float32
        # request carrying the same values; one flipped bit fails
        # INVALID_ARGUMENT corrupt-wire.
        bits = (wts.view(np.uint32) >> 16).astype(np.uint16)
        bf16_stamp = (f"feat_ids={codec.ndarray_crc(ids):08x},feat_wts="
                      f"{codec.crc32c(bits.tobytes(), codec.crc32c(f'<V2:{bits.shape}'.encode())):08x}")

        def bf16_request(payload_bits):
            r = _request(ids, wts)
            t = r.inputs["feat_wts"]
            t.Clear()
            t.dtype = codec.DataType.DT_BFLOAT16
            t.tensor_shape.CopyFrom(codec.shape_to_proto(payload_bits.shape))
            t.tensor_content = payload_bits.tobytes()
            return r

        got_bf16 = _scores_of(stub.Predict(bf16_request(bits), timeout=60,
                                           metadata=((codec.CRC_INPUT_MD, bf16_stamp),)))
        widened = (bits.astype(np.uint32) << 16).view(np.float32)
        if not np.array_equal(got_bf16, _scores_of(stub.Predict(_request(ids, widened),
                                                                timeout=60))):
            fail("integrity: the bf16-stamped Predict lost the bits of its float32 twin")
        flipped = bits.copy()
        flipped.reshape(-1)[7] ^= 1
        try:
            stub.Predict(bf16_request(flipped), timeout=60,
                         metadata=((codec.CRC_INPUT_MD, bf16_stamp),))
            fail("integrity: a bf16 payload with a flipped bit answered")
        except grpc.RpcError as e:
            if e.code().name != "INVALID_ARGUMENT" or "corrupt-wire" not in e.details():
                fail(f"integrity: the flipped bf16 payload ended {e.code().name}: {e.details()}")
        w2 = plane.snapshot()["wire"]
        if (w2["inputs_verified"] - w1["inputs_verified"] != 1
                or w2["inputs_rejected"] - w1["inputs_rejected"] != 1):
            fail(f"integrity: bf16 wire counters {w1} -> {w2}")
        out["bf16_stamp"] = {"verified": 1, "rejected": 1}
        log("integrity: a bf16 feat_wts stamped over its wire bits answers OK (the bits of its "
            "float32 twin); one flipped bit -> INVALID_ARGUMENT corrupt-wire")

        def decode_mean(stamped: bool) -> float:
            md = ((codec.CRC_INPUT_MD, stamp),) if stamped else ()
            s0 = request_trace.snapshot().get("predict.decode", {"total_ms": 0.0, "count": 0})
            for _ in range(INTEGRITY_DECODE[1]):
                stub.Predict(req, timeout=60, metadata=md)
            s1 = request_trace.snapshot()["predict.decode"]
            return (s1["total_ms"] - s0["total_ms"]) / (s1["count"] - s0["count"]) * 1e3

        runs = [("off", decode_mean(False)), ("on", decode_mean(True)),
                ("on", decode_mean(True)), ("off", decode_mean(False))]
        out["wire"] = {"decode_us_runs": runs,
                       "decode_us_unstamped": statistics.mean(v for k, v in runs if k == "off"),
                       "decode_us_stamped": statistics.mean(v for k, v in runs if k == "on"),
                       "stamp": stamp}
        log(f"integrity: wire CRC over gRPC: clean stamp verified, a wrong hex digit -> "
            f"INVALID_ARGUMENT alone (its concurrent clean twin answered), every response's "
            f"x-dts-score-crc verifies; predict.decode at n = {INTEGRITY_DECODE[0]} "
            f"(off/on/on/off, {INTEGRITY_DECODE[1]} each): "
            + ", ".join(f"{k} {v:.1f} us" for k, v in runs) + f" ({name})")

        # (e) The REST surfaces, in process.
        rport, stop_rest = _rest_in_process(impl, ServerMetrics())
        http = _Http(rport)
        try:
            body = http.json("GET", "/integrityz")
            if not body.get("enabled") or body["shadow"]["mismatches"] < 1:
                fail(f"integrity: /integrityz {body}")
            sh0 = plane.snapshot()["shadow"]
            audit = http.json("POST", "/integrityz/audit?batches=2")
            if audit != {"requested": 2, "pending_audits": 2}:
                fail(f"integrity: audit answered {audit}")
            for _ in range(3):
                _scores(batcher, sv, *payload(256))
            sh1 = plane.snapshot()["shadow"]
            if sh1["batches"] - sh0["batches"] != 2 or sh1["audits_run"] - sh0["audits_run"] != 2:
                fail(f"integrity: the audit shadowed {sh1['batches'] - sh0['batches']} batches")
            sec = http.json("GET", "/monitoring?section=integrity")
            if set(sec) != {"integrity"} or not sec["integrity"]["enabled"]:
                fail(f"integrity: ?section=integrity {sorted(sec)}")
            status, text = http.call("GET", "/monitoring/prometheus/metrics")
            text = text.decode()
            series = [ln for ln in text.splitlines() if ln.startswith("dts_tpu_integrity_")]
            lint = subprocess.run([sys.executable, os.path.join(HERE, "tools", "check_prom.py"),
                                   "-"], input=text, capture_output=True, text=True, timeout=60)
            if status != 200 or len(series) < 11 or lint.returncode != 0:
                fail(f"integrity: exposition {status}, {len(series)} dts_tpu_integrity_ lines, "
                     f"lint {lint.stdout[-300:]}{lint.stderr[-300:]}")
        finally:
            http.close()
            stop_rest()
        out["surfaces"] = {"series": len(series), "audits_run": sh1["audits_run"]}
        log(f"integrity: /integrityz, POST /integrityz/audit?batches=2 (2 batches shadowed at "
            f"shadow_fraction 0), ?section=integrity, {len(series)} lint-clean "
            "dts_tpu_integrity_* lines")

        # (f) The shadow's cost: a closed loop at shadow_fraction 0 / 1 / 1 / 0.
        clients, per_client, n = INTEGRITY_LOOP
        loop_payloads = [payload(n) for _ in range(clients)]
        runs = []
        for frac in (0.0, 1.0, 1.0, 0.0):
            plane.config = dataclasses.replace(plane.config, shadow_fraction=frac)
            d0 = request_trace.snapshot().get("batch.shadow_dispatch",
                                              {"total_ms": 0.0, "count": 0})
            r = closed_loop(port, loop_payloads, per_client)
            d1 = request_trace.snapshot().get("batch.shadow_dispatch", d0)
            r["shadow_fraction"] = frac
            r["shadow_dispatch_us"] = ((d1["total_ms"] - d0["total_ms"]) * 1e3
                                       / (d1["count"] - d0["count"])
                                       if d1["count"] > d0["count"] else None)
            runs.append(r)
            log(f"integrity: closed loop {clients} x {per_client} n={n} shadow_fraction {frac}: "
                f"p50 {r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms qps {r['qps']:.1f} "
                f"busy {r['device_busy_share']:.3f}"
                + (f" batch.shadow_dispatch {r['shadow_dispatch_us']:.1f} us"
                   if r["shadow_dispatch_us"] is not None else "") + f" ({name})")
        out["cost"] = runs
        if plane.snapshot()["shadow"]["mismatches"] != 1:  # the bitflip's, no other
            fail(f"integrity: shadow mismatches {plane.snapshot()['shadow']}")
    finally:
        faults.get().clear()
        for ch in stubs:
            ch.close()
        for server in servers:
            server.stop(grace=1).wait()
        for impl, batcher, *_ in stacks.values():
            batcher.stop()
    return out


OVERLOAD_TOML = ("\n[overload]\nenabled = true\ntarget_queue_wait_ms = 5.0\n"
                 "queue_wait_window_s = 2.0\nadjust_interval_s = 0.1\n")
OVERLOAD_LOAD = (16, 150, 2048, 0.050)  # clients, Predicts each, candidates, deadline (s)
# The clients run in OVERLOAD_PROCS processes of their own (4 threads
# each), so their encode and decode take no time from the server's
# interpreter: what the server spends is its own transport and its queue.
OVERLOAD_PROCS = 4
OVERLOAD_PAYLOADS = 8  # distinct n = 2048 payloads of the load
OVERLOAD_MIN_SAMPLES = 100  # admitted answers below which a run reports no p99
# The trickle's period, and the bound on its return to NOMINAL (s): the
# over-target waits of the load stay in the 2 s window, and each of the two
# steps down takes 6 under-target ticks of 0.1 s, so about 3.2 s at best;
# with fewer than 100 samples in the window one wait over 5 ms keeps it
# over target for 2 s more (3.0-11.1 s measured on the card).
OVERLOAD_TRICKLE = (0.050, 30.0)
OVERLOAD_TTL_S = 0.5  # [cache] ttl_s and row_ttl_s of the brownout stack


def _overload_clients(port, proc, threads, load, keys, reqs, refs, barrier, results) -> None:
    """One client process of the overload load (started with spawn):
    `threads` clients, each with its own channel, sending `load` = (per
    client, deadline) serialized Predicts of `reqs`, client k of the load
    in the sheddable lane when k is even. A client refused
    RESOURCE_EXHAUSTED sleeps the retry-after-ms it was sent. Puts
    (records, wrong, hints, answers with no message, end time) or
    ("error", text) on `results`."""
    import threading
    import traceback

    try:
        import grpc
        import numpy as np

        from distributed_tf_serving_tpu_torch import codec
        from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

        crit_key, retry_key = keys
        per_client, deadline = load
        records, wrong, hints, empty = [], [], [], []
        lock = threading.Lock()
        chans = [_channel(port) for _ in range(threads)]

        def client(t):
            k = proc * threads + t
            call = chans[t].unary_unary("/tensorflow.serving.PredictionService/Predict",
                                        response_deserializer=apis.PredictResponse.FromString)
            md = ((crit_key, "sheddable" if k % 2 == 0 else "critical"),)
            mine = []
            for i in range(per_client):
                j = (k + i) % len(reqs)
                t0 = time.perf_counter()
                try:
                    resp, rpc = call.with_call(reqs[j], timeout=deadline, metadata=md)
                    dt = time.perf_counter() - t0
                    if resp is None:
                        # Status OK and no message (seen on the card with
                        # the answer at the deadline): recorded with what
                        # the call says, never read as an answer.
                        mine.append((md[0][1], "OK_NO_MESSAGE", dt))
                        with lock:
                            empty.append((round(dt * 1e3, 3), rpc.code().name,
                                          dict(rpc.trailing_metadata() or ())))
                        continue
                    got = codec.to_ndarray(resp.outputs["prediction_node"])
                    if not np.array_equal(got, refs[j]):
                        with lock:
                            wrong.append(j)
                    mine.append((md[0][1], "OK", dt))
                except grpc.RpcError as e:
                    dt = time.perf_counter() - t0
                    code = e.code().name
                    mine.append((md[0][1], code, dt))
                    if code == "RESOURCE_EXHAUSTED":
                        ra = _md(e).get(retry_key)
                        with lock:
                            hints.append(int(ra) if ra is not None else None)
                        if ra is not None:
                            time.sleep(int(ra) / 1e3)
            with lock:
                records.extend(mine)

        for ch in chans:
            grpc.channel_ready_future(ch).result(timeout=60)
        ths = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
        barrier.wait(timeout=120)
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        end = time.time()
        for ch in chans:
            ch.close()
        results.put((records, wrong, hints, empty, end))
    except BaseException:  # noqa: BLE001 — the parent fails the phase with it
        results.put(("error", traceback.format_exc()))


def _overload_load(port, payloads, refs, ctrl) -> dict:
    """The load: OVERLOAD_LOAD clients in OVERLOAD_PROCS processes, half
    sending `x-dts-criticality: sheddable` and half `critical`, each Predict
    (tensor_content, as tf.make_tensor_proto writes it) with a 50 ms
    deadline; a client refused RESOURCE_EXHAUSTED sleeps the retry-after-ms
    it was sent. Every admitted answer must have the bits of `refs`. A
    monitor thread records the pressure states seen; the server's
    predict.decode / execute / encode means over the run say where an
    answer's time went."""
    import multiprocessing
    import queue
    import threading

    from distributed_tf_serving_tpu_torch.serving import overload as overload_mod
    from distributed_tf_serving_tpu_torch.utils.tracing import request_trace

    clients, per_client, _, deadline = OVERLOAD_LOAD
    reqs = [_request(*p).SerializeToString() for p in payloads]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    barrier = ctx.Barrier(OVERLOAD_PROCS + 1)
    keys = (overload_mod.CRITICALITY_KEY, overload_mod.RETRY_AFTER_KEY)
    procs = [ctx.Process(target=_overload_clients, daemon=True,
                         args=(port, k, clients // OVERLOAD_PROCS, (per_client, deadline), keys,
                               reqs, refs, barrier, results)) for k in range(OVERLOAD_PROCS)]
    states, done = set(), threading.Event()
    phases = ("predict.decode", "predict.execute", "predict.encode")

    def monitor():
        while not done.is_set():
            if ctrl is not None:
                states.add(ctrl.state())
            time.sleep(0.01)

    mon = threading.Thread(target=monitor)
    records, wrong, hints, empty, ends = [], 0, [], [], []
    try:
        for p in procs:
            p.start()
        mon.start()
        barrier.wait(timeout=180)
        t0 = time.time()
        ph0 = request_trace.snapshot()
        for _ in procs:
            try:
                got = results.get(timeout=600)
            except queue.Empty:
                fail("overload: a client process gave no result in 600 s")
            if got[0] == "error":
                fail(f"overload: a client process failed: {got[1]}")
            records.extend(got[0])
            wrong += len(got[1])
            hints.extend(got[2])
            empty.extend(got[3])
            ends.append(got[4])
        ph1 = request_trace.snapshot()
        wall = max(ends) - t0
    finally:
        done.set()
        mon.join(5)
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(5)
    if len(records) != clients * per_client:
        fail(f"overload: {len(records)} of {clients * per_client} Predicts recorded")
    ok = sorted(dt * 1e3 for _, code, dt in records if code == "OK")
    codes: dict = {}
    for lane, code, _ in records:
        codes.setdefault(lane, {}).setdefault(code, 0)
        codes[lane][code] += 1
    good = sum(1 for _, code, dt in records if code == "OK" and dt <= deadline)
    server_us = {}
    for ph in phases:
        a, b = ph0.get(ph, {"total_ms": 0.0, "count": 0}), ph1.get(ph, {"total_ms": 0.0, "count": 0})
        if b["count"] > a["count"]:
            server_us[ph] = (b["total_ms"] - a["total_ms"]) / (b["count"] - a["count"]) * 1e3
    return {"requests": len(records), "wall_s": wall, "codes": codes, "wrong": wrong,
            "hints": hints, "states": sorted(states), "admitted": len(ok),
            "ok_no_message": empty,
            "admitted_p50_ms": statistics.median(ok) if ok else None,
            # A p99 only over enough answers to hold one.
            "admitted_p99_ms": (ok[math.ceil(0.99 * len(ok)) - 1]
                                if len(ok) >= OVERLOAD_MIN_SAMPLES else None),
            "in_time": good, "goodput_per_s": good / wall, "server_phase_us": server_us}


def phase_overload(dev, name: str) -> dict:
    """The overload plane on the card (serving/overload.py and its wiring)
    on the threaded gRPC server: shedding under real load with
    retry-after-ms, the return to NOMINAL, the `pressure` site's brownout
    stale-serve (score and row cache, marked degraded, no launch) and SHED
    refusals over gRPC and REST, and the surfaces. Checks in the docstring
    of the module."""
    import grpc
    import numpy as np

    from distributed_tf_serving_tpu_torch import codec, faults
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.serving import overload as overload_mod
    from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server
    from distributed_tf_serving_tpu_torch.utils.config import CacheConfig, load_config
    from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics

    toml = os.path.join(HERE, "chiprun_out", "overload.toml")
    os.makedirs(os.path.dirname(toml), exist_ok=True)
    with open(os.path.join(HERE, "configs", "latency.toml")) as f:
        text = f.read()
    with open(toml, "w") as f:
        f.write(text + OVERLOAD_TOML)
    loaded = load_config(toml)
    cfg, model_cfg, oc = loaded["server"], loaded["model"], loaded["overload"]
    fields = model_cfg.num_fields
    rng = np.random.RandomState(SEED + 15)

    def payload(n):
        return (rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
                rng.rand(n, fields).astype(np.float32))

    out: dict = {"card": name, "config": dataclasses.asdict(oc)}
    servers, chans, stops, batchers = [], [], [], []
    try:
        # (a) Real load on the fused serve stack.
        impl, batcher, sv = build_stack(cfg, model_cfg, "cuda", seed=SEED, overload_config=oc)
        batchers.append(batcher)
        ctrl = batcher.overload
        server, port = create_server(impl, "127.0.0.1:0", max_workers=32)
        server.start()
        servers.append(server)
        n = OVERLOAD_LOAD[2]
        payloads = [payload(n) for _ in range(OVERLOAD_PAYLOADS)]
        batcher.overload = None  # the references: the same stack, the plane detached
        refs = [_scores(batcher, sv, ids, wts) for ids, wts in payloads]
        batcher.overload = ctrl
        stub_ch = _channel(port)
        chans.append(stub_ch)
        stub = PredictionServiceStub(stub_ch)
        runs, launches = [], {}
        for armed in (False, True, True, False):
            batcher.overload = ctrl if armed else None
            snap0 = ctrl.snapshot()
            ck.reset_launches()
            r = _overload_load(port, payloads, refs, ctrl if armed else None)
            if armed:
                for key, v in _launch_counts().items():
                    launches[key] = launches.get(key, 0) + v
            snap1 = ctrl.snapshot()
            r["armed"] = armed
            r["limit_final"] = snap1["limit"] if armed else None
            r["state_changes"] = snap1["state_changes"] - snap0["state_changes"]
            r["sheds"] = snap1["sheds"] - snap0["sheds"]
            r["doomed_refusals"] = snap1["doomed_refusals"] - snap0["doomed_refusals"]
            r["sheds_by_lane"] = {k: snap1["sheds_by_lane"][k] - snap0["sheds_by_lane"][k]
                                  for k in snap1["sheds_by_lane"]}
            if r["wrong"]:
                fail(f"overload: {r['wrong']} admitted answers lost the plane-off bits")
            if armed:
                refused = {lane: c.get("RESOURCE_EXHAUSTED", 0) / sum(c.values())
                           for lane, c in r["codes"].items()}
                r["refusal_share"] = refused
                if r["sheds"] < 1 or not r["hints"]:
                    fail(f"overload: no shed under load: {r['codes']}")
                bad = [h for h in r["hints"] if h is None
                       or not oc.retry_after_floor_ms <= h <= oc.retry_after_cap_ms]
                if bad:
                    fail(f"overload: refusals without a retry-after-ms in "
                         f"[{oc.retry_after_floor_ms}, {oc.retry_after_cap_ms}]: {bad[:5]}")
                if r["states"] == [overload_mod.NOMINAL]:
                    fail("overload: the pressure state never left NOMINAL under load")
                if refused["sheddable"] < refused["critical"]:
                    fail(f"overload: the sheddable lane's refusal share {refused['sheddable']} "
                         f"is below the critical lane's {refused['critical']}")
                # The trickle: 1 Predict per 50 ms until NOMINAL.
                t0, trickle = time.perf_counter(), 0
                while ctrl.state() != overload_mod.NOMINAL:
                    if time.perf_counter() - t0 > OVERLOAD_TRICKLE[1]:
                        fail(f"overload: still {ctrl.state()} after a "
                             f"{OVERLOAD_TRICKLE[1]} s trickle")
                    stub.Predict(_request(*payloads[0]), timeout=60)
                    trickle += 1
                    time.sleep(OVERLOAD_TRICKLE[0])
                r["nominal_after_s"] = time.perf_counter() - t0
                r["trickle_requests"] = trickle
            hinted = [h for h in r["hints"] if h is not None]
            r["hints"] = {"refusals": len(r["hints"]), "hinted": len(hinted),
                          "min_ms": min(hinted, default=None), "max_ms": max(hinted, default=None)}
            runs.append(r)
            log(f"overload: {'on ' if armed else 'off'} {OVERLOAD_LOAD[0]} x {OVERLOAD_LOAD[1]} "
                f"n={n} deadline {OVERLOAD_LOAD[3] * 1e3:.0f} ms, clients in "
                f"{OVERLOAD_PROCS} processes: {r['admitted']} admitted, p50 "
                f"{r['admitted_p50_ms']} ms p99 {r['admitted_p99_ms']} ms (none below "
                f"{OVERLOAD_MIN_SAMPLES} answers), {r['in_time']} in time, "
                f"{len(r['ok_no_message'])} OK with no message, goodput "
                f"{r['goodput_per_s']:.1f}/s in {r['wall_s']:.2f} s, server us "
                f"{ {k: round(v, 1) for k, v in r['server_phase_us'].items()} } "
                f"codes {r['codes']} sheds {r['sheds']} doomed "
                f"{r['doomed_refusals']} limit {r['limit_final']} states {r['states']} "
                + (f"back to NOMINAL in {r['nominal_after_s']:.2f} s " if armed else "")
                + f"({name})")
        batcher.overload = ctrl
        out["load"] = runs
        out["launches"] = launches
        if launches.get("fused_serve/bfloat16", 0) <= 0:
            fail(f"overload: the armed load launched fused_serve/bfloat16 no time ({launches})")

        # (b) The `pressure` site pins BROWNOUT: stale answers, marked, no
        # launch, no refill, on the score cache and the row tier.
        cc = CacheConfig(enabled=True, row_granular=True, ttl_s=OVERLOAD_TTL_S,
                         row_ttl_s=OVERLOAD_TTL_S)
        oc2 = dataclasses.replace(oc, adjust_interval_s=0.05)
        impl2, batcher2, sv2 = build_stack(cfg, model_cfg, "cuda", seed=SEED, cache_config=cc,
                                           overload_config=oc2)
        batchers.append(batcher2)
        ctrl2 = batcher2.overload
        server2, port2 = create_server(impl2, "127.0.0.1:0")
        server2.start()
        servers.append(server2)
        ch2 = _channel(port2)
        chans.append(ch2)
        stub2 = PredictionServiceStub(ch2)
        crit = ((overload_mod.CRITICALITY_KEY, "critical"),)
        rport, stop_rest = _rest_in_process(impl2, ServerMetrics())
        stops.append(stop_rest)
        http = _Http(rport)
        ids, wts = payload(1000)
        rest_body = json.dumps({"inputs": {"feat_ids": ids.tolist(),
                                           "feat_wts": wts.tolist()}}).encode()

        def rest_scores(raw):
            outs = json.loads(raw)["outputs"]
            return np.asarray(outs["prediction_node"] if isinstance(outs, dict) else outs,
                              np.float32)

        # The fills: over gRPC (output_filter prediction_node) and over REST
        # (every output): two entries of each store.
        fresh = codec.to_ndarray(stub2.Predict(_request(ids, wts), timeout=60,
                                               metadata=crit).outputs["prediction_node"])
        fresh_rest = rest_scores(http.call("POST", "/v1/models/DCN:predict", rest_body)[1])
        time.sleep(OVERLOAD_TTL_S + 0.1)  # past the TTL, inside the stale window
        faults.get().add("pressure", "error", code="BROWNOUT")
        time.sleep(0.1)
        if ctrl2.state() != overload_mod.BROWNOUT:
            fail(f"overload: the pressure rule left the state {ctrl2.state()}")
        fills0 = batcher2.score_cache.snapshot()["fills"]
        ck.reset_launches()
        resp, call = stub2.Predict.with_call(_request(ids, wts), timeout=60, metadata=crit)
        stale_launches = {k: v for k, v in _launch_counts().items() if v}
        if _md(call).get(overload_mod.DEGRADED_KEY) != "stale":
            fail(f"overload: the stale answer's trailing metadata {_md(call)}")
        if not np.array_equal(codec.to_ndarray(resp.outputs["prediction_node"]), fresh):
            fail("overload: the stale answer is not the cached bits")
        if stale_launches or batcher2.score_cache.snapshot()["fills"] != fills0:
            fail(f"overload: the stale serve launched {stale_launches} or refilled")
        # The row tier: 900 of those (stale) rows and 100 fresh ones.
        fids, fwts = payload(100)
        qids, qwts = np.concatenate([ids[:900], fids]), np.concatenate([wts[:900], fwts])
        r0 = batcher2.row_cache.snapshot()["stale_serves"]
        resp, call = stub2.Predict.with_call(_request(qids, qwts), timeout=60, metadata=crit)
        got = codec.to_ndarray(resp.outputs["prediction_node"])
        if (_md(call).get(overload_mod.DEGRADED_KEY) != "stale"
                or not np.array_equal(got[:900], fresh[:900])
                or batcher2.row_cache.snapshot()["stale_serves"] - r0 != 900):
            fail(f"overload: the row-tier stale serve: metadata {_md(call)}, rows "
                 f"{batcher2.row_cache.snapshot()['stale_serves'] - r0}")
        out["brownout"] = {"stale_launches": stale_launches, "row_stale_serves": 900,
                           "brownout_serves": ctrl2.snapshot()["brownout_serves"]}
        log("overload: pressure=BROWNOUT -> an expired request answered stale (x-dts-degraded: "
            "stale, its cached bits, 0 launches, no refill); a request of 900 expired rows + 100 "
            "fresh answered with the mark (900 row stale serves)")

        # (c) The `pressure` site pins SHED.
        faults.get().clear()
        faults.get().add("pressure", "error", code="SHED")
        time.sleep(0.1)
        if ctrl2.state() != overload_mod.SHED:
            fail(f"overload: the SHED rule left the state {ctrl2.state()}")
        sids, swts = payload(256)
        try:
            stub2.Predict(_request(sids, swts), timeout=60,
                          metadata=((overload_mod.CRITICALITY_KEY, "sheddable"),))
            fail("overload: a sheddable Predict was admitted under SHED")
        except grpc.RpcError as e:
            ra = _md(e).get(overload_mod.RETRY_AFTER_KEY)
            if e.code() != grpc.StatusCode.RESOURCE_EXHAUSTED or ra is None:
                fail(f"overload: the sheddable Predict ended {e.code()} ({_md(e)})")
        stub2.Predict(_request(sids, swts), timeout=60, metadata=crit)  # critical: admitted
        try:
            body = json.dumps({"inputs": {"feat_ids": sids.tolist(),
                                          "feat_wts": swts.tolist()}}).encode()
            http.conn.request("POST", "/v1/models/DCN:predict", body=body, headers={
                "Content-Type": "application/json", overload_mod.CRITICALITY_KEY: "sheddable"})
            r = http.conn.getresponse()
            r.read()
            retry = r.getheader("Retry-After")
            if r.status != 429 or not retry or int(retry) < 1:
                fail(f"overload: REST 429 without Retry-After ({r.status}, {retry!r})")
            http.conn.request("POST", "/v1/models/DCN:predict", body=rest_body, headers={
                "Content-Type": "application/json", overload_mod.CRITICALITY_KEY: "critical"})
            r = http.conn.getresponse()
            scores = rest_scores(r.read())
            if r.status != 200 or r.getheader(overload_mod.DEGRADED_KEY) != "stale":
                fail(f"overload: REST stale answer {r.status}, X-DTS-Degraded "
                     f"{r.getheader(overload_mod.DEGRADED_KEY)!r}")
            if not np.array_equal(scores, fresh_rest):
                fail("overload: the REST stale answer is not the cached bits")
            # (d) The surfaces agree with overload_stats().
            sec = http.json("GET", "/monitoring?section=overload")["overload"]
            status, prom = http.call("GET", "/monitoring/prometheus/metrics")
            prom = prom.decode()
            snap = impl2.overload_stats()
            for key in ("state", "sheds", "admitted", "doomed_refusals", "brownout_serves",
                        "limit", "sheds_by_lane"):
                if sec[key] != snap[key]:
                    fail(f"overload: /monitoring {key} {sec[key]} != overload_stats {snap[key]}")
            want = [f"dts_tpu_overload_sheds_total {snap['sheds']}",
                    f"dts_tpu_overload_brownout_serves_total {snap['brownout_serves']}",
                    f"dts_tpu_overload_admitted_total {snap['admitted']}",
                    'dts_tpu_overload_pressure_state{state="shed"} 1']
            missing = [w for w in want if w not in prom.splitlines()]
            lint = subprocess.run([sys.executable, os.path.join(HERE, "tools", "check_prom.py"),
                                   "-"], input=prom, capture_output=True, text=True, timeout=60)
            if missing or lint.returncode != 0:
                fail(f"overload: the exposition lacks {missing} or fails the lint "
                     f"{lint.stdout[-300:]}")
        finally:
            http.close()
        out["shed"] = {"rest_retry_after_s": int(retry),
                       "series": sum(1 for ln in prom.splitlines()
                                     if ln.startswith("dts_tpu_overload_"))}
        log(f"overload: pressure=SHED -> sheddable RESOURCE_EXHAUSTED with retry-after-ms, "
            f"critical admitted; REST 429 Retry-After {retry}, a stale REST answer "
            f"X-DTS-Degraded: stale; /monitoring?section=overload and "
            f"{out['shed']['series']} lint-clean dts_tpu_overload_* lines = overload_stats()")
    finally:
        faults.get().clear()
        for stop in stops:
            stop()
        for ch in chans:
            ch.close()
        for server in servers:
            server.stop(grace=1).wait()
        for b in batchers:
            b.stop()
    return out


# The cascade phase: the ranking cascade (serving/cascade.py) on the bf16
# fused-serve stack of configs/latency.toml.
CASCADE_SIZES = (1000, 1000, 2048, 2048)  # the eligible Predicts of the launch window
CASCADE_LOOP = (100, 2048)  # timed Predicts per run (off / on / on / off), candidates
CASCADE_SMALL = 7  # below min_candidates: bypasses the cascade


def phase_cascade(dev, name: str) -> dict:
    """The ranking cascade on the card: a stack from build_stack on
    configs/latency.toml with [cascade] enabled (stage 1 the in-process
    two_tower `stage1`, seed-0 weights; the shadow off), beside a plane-off
    stack on the same weights, each on a threaded gRPC server. Checks in
    the docstring of the module."""
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch import codec
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.serving.batcher import bucket_for
    from distributed_tf_serving_tpu_torch.serving.cascade import STAGE1, STAGE2, STAGE_OUTPUT
    from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server
    from distributed_tf_serving_tpu_torch.utils.config import CascadeConfig, load_config
    from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics
    from distributed_tf_serving_tpu_torch.utils.tracing import request_trace

    loaded = load_config(os.path.join(HERE, "configs", "latency.toml"))
    cfg, model_cfg = loaded["server"], loaded["model"]
    fields = model_cfg.num_fields
    rng = np.random.RandomState(SEED + 16)

    def payload(n):
        return (rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
                rng.rand(n, fields).astype(np.float32))

    out: dict = {"card": name}
    servers, chans, batchers, stops = [], [], [], []
    try:
        impl, on, sv = build_stack(cfg, model_cfg, "cuda", seed=SEED,
                                   cascade_config=CascadeConfig(enabled=True))
        batchers.append(on)
        impl_off, off, _ = build_stack(cfg, model_cfg, "cuda", seed=SEED)
        batchers.append(off)
        casc = impl.cascade
        if casc is None or on.integrity is not None or impl_off.cascade is not None:
            fail("cascade: [cascade] enabled did not arm the plane (alone) on one stack")
        s1 = impl.registry.resolve(casc.stage1_model)
        if s1.model.kind != "two_tower":
            fail(f"cascade: stage 1 is {s1.model.kind}, want two_tower")
        if not on.step_for(sv).fused or on.step_for(s1).fused:
            fail("cascade: stage 2 must serve through the fused kernel, stage 1 through "
                 "model.apply")
        stubs = {}
        for label, im in (("on", impl), ("off", impl_off)):
            server, port = create_server(im, "127.0.0.1:0")
            server.start()
            servers.append(server)
            chans.append(_channel(port))
            stubs[label] = PredictionServiceStub(chans[-1])

        def predict(label, ids, wts, model="DCN", filtered=True):
            req = _request(ids, wts)
            req.model_spec.name = model
            if not filtered:
                del req.output_filter[:]
            t0 = time.perf_counter()
            resp = stubs[label].Predict(req, timeout=120)
            ms = (time.perf_counter() - t0) * 1e3
            got = _scores_of(resp)
            if got.shape != (len(ids),) or not np.all(np.isfinite(got)):
                fail(f"cascade: {label} {model} answered shape {got.shape} for {len(ids)} rows")
            stage = (codec.to_ndarray(resp.outputs[STAGE_OUTPUT])
                     if STAGE_OUTPUT in resp.outputs else None)
            return got, stage, ms

        def plain(servable, ids, wts):
            with torch.inference_mode():
                return servable.model.apply(servable.params, {
                    "feat_ids": torch.from_numpy(ids).to(dev),
                    "feat_wts": torch.from_numpy(wts).to(dev)})["prediction_node"].float().cpu().numpy()

        # 1. The eligible Predicts. The references (a direct stage-1 Predict
        # on the armed stack, the survivors alone on the plane-off stack)
        # run inside the launch window: their launches are counted apart.
        ref_launches: dict = {}

        def reference(*args, **kw):
            l0 = _launch_counts()
            got = predict(*args, **kw)[0]
            for k, v in _launch_counts().items():
                ref_launches[k] = ref_launches.get(k, 0) + v - l0.get(k, 0)
            return got

        c0, st0 = casc.snapshot(), dataclasses.replace(on.stats)
        checks, sent_rows, sent_survivors = [], 0, 0
        ck.reset_launches()
        for n in CASCADE_SIZES:
            ids, wts = payload(n)
            k = casc.plan_k(n)
            scores, stage, ms = predict("on", ids, wts)
            if stage is None or stage.shape != (n,) or stage.dtype != np.int32:
                fail(f"cascade: n={n}: no int32 cascade_stage of {n} rows")
            surv, pruned = np.where(stage == STAGE2)[0], np.where(stage == STAGE1)[0]
            if len(surv) != k or len(pruned) != n - k:
                fail(f"cascade: n={n}: {len(surv)} rows ranked, want plan_k = {k}")
            s1_direct = reference("on", ids, wts, model=casc.stage1_model)
            want = np.argsort(-s1_direct, kind="stable")[:k]
            if set(surv.tolist()) != set(want.tolist()):
                fail(f"cascade: n={n}: the ranked rows are not the stable top-{k} of a direct "
                     "stage-1 Predict")
            if not np.array_equal(scores[pruned], s1_direct[pruned]):
                fail(f"cascade: n={n}: pruned rows are not the bits of the direct stage-1 "
                     "Predict")
            s2_alone = reference("off", ids[surv], wts[surv])
            if not np.array_equal(scores[surv], s2_alone):
                fail(f"cascade: n={n}: survivor rows are not the bits of a plane-off Predict "
                     "of those rows alone")
            truth = np.where(stage == STAGE2, plain(sv, ids, wts), plain(s1, ids, wts))
            err = float(np.max(np.abs(scores - truth)))
            if err > APPLY_TOL:
                fail(f"cascade: n={n}: max |dscore| vs the plain forward {err} > {APPLY_TOL}")
            checks.append({"n": n, "k": k, "survivor_bucket": bucket_for(k, cfg.buckets),
                           "max_abs_err": err, "ms": ms})
            sent_rows += n
            sent_survivors += k
        launches = _launch_counts()
        path = {key: v - ref_launches.get(key, 0) for key, v in launches.items()}
        out["launches"], out["reference_launches"] = path, ref_launches
        out["predicts"] = checks
        eligible = len(CASCADE_SIZES)
        others = {key: v for key, v in path.items() if v and key != "fused_serve/bfloat16"}
        if path.get("fused_serve/bfloat16", 0) != eligible or others:
            fail(f"cascade: the path launched {path} for {eligible} eligible Predicts (want "
                 "fused_serve/bfloat16 once each, nothing else)")
        c1, st1 = casc.snapshot(), on.stats
        moved = {key: c1[key] - c0[key] for key in ("requests", "host_prunes", "fallbacks",
                                                    "rows_requested", "survivor_rows")}
        if (moved != {"requests": eligible, "host_prunes": 0, "fallbacks": 0,
                      "rows_requested": sent_rows, "survivor_rows": sent_survivors}
                or st1.prune_batches - st0.prune_batches != eligible
                or st1.prune_fallback_batches != st0.prune_fallback_batches):
            fail(f"cascade: counters moved {moved}, prune batches "
                 f"{st1.prune_batches - st0.prune_batches}, fallback batches "
                 f"{st1.prune_fallback_batches - st0.prune_fallback_batches} for {eligible} "
                 "eligible Predicts")
        log(f"cascade: {eligible} Predicts (n = {sorted(set(CASCADE_SIZES))}): ranked rows = "
            "the stable top-k of stage 1, survivors the bits of a plane-off Predict of them "
            "alone, pruned rows the bits of stage 1, max |dscore| vs the plain forward "
            f"{max(c['max_abs_err'] for c in checks):.2e}; launches {path} (references apart: "
            f"{ref_launches}); prune batches {eligible}, host prunes 0, fallbacks 0 ({name})")

        # 2. The bypasses: below min_candidates, and no output filter.
        for label, n, filtered in (("n=7", CASCADE_SMALL, True), ("unfiltered", 1000, False)):
            ids, wts = payload(n)
            got, stage, _ = predict("on", ids, wts, filtered=filtered)
            ref = predict("off", ids, wts, filtered=filtered)[0]
            if stage is not None or not np.array_equal(got, ref):
                fail(f"cascade: the {label} Predict carried cascade_stage or lost the "
                     "plane-off bits")
        if casc.snapshot()["requests"] != c1["requests"]:
            fail("cascade: a bypassing Predict entered the cascade")
        log("cascade: n = 7 and an unfiltered Predict bypass it (no cascade_stage, the "
            "plane-off bits)")

        # 3. The surfaces, in process.
        rport, stop_rest = _rest_in_process(impl, ServerMetrics())
        stops.append(stop_rest)
        http = _Http(rport)
        try:
            cz = http.json("GET", "/cascadez")
            sec = http.json("GET", "/monitoring?section=cascade")["cascade"]
            status, prom = http.call("GET", "/monitoring/prometheus/metrics")
            prom = prom.decode()
        finally:
            http.close()
        snap = impl.cascade_stats()
        for key in ("requests", "fallbacks", "host_prunes", "rows_requested", "survivor_rows",
                    "pruned_rows"):
            if not cz[key] == sec[key] == snap[key]:
                fail(f"cascade: /cascadez {key} {cz[key]}, /monitoring {sec[key]}, "
                     f"snapshot {snap[key]}")
        want = [f"dts_tpu_cascade_requests_total {eligible}",
                "dts_tpu_cascade_host_prunes_total 0",
                "dts_tpu_cascade_fallbacks_total 0",
                f'dts_tpu_cascade_rows_total{{disposition="requested"}} {sent_rows}',
                f'dts_tpu_cascade_rows_total{{disposition="survivor"}} {sent_survivors}']
        missing = [w for w in want if w not in prom.splitlines()]
        lint = subprocess.run([sys.executable, os.path.join(HERE, "tools", "check_prom.py"), "-"],
                              input=prom, capture_output=True, text=True, timeout=60)
        series = sum(1 for ln in prom.splitlines() if ln.startswith("dts_tpu_cascade_"))
        if missing or lint.returncode != 0 or cz["requests"] != eligible:
            fail(f"cascade: /cascadez {cz}; the exposition lacks {missing} or fails the lint "
                 f"{lint.stdout[-300:]}")
        out["cascadez"] = cz
        log(f"cascade: /cascadez = /monitoring?section=cascade = cascade_stats(); "
            f"{series} lint-clean dts_tpu_cascade_* lines; survivor_buckets "
            f"{cz['survivor_buckets']}")

        # 4. The cost: Predicts of n = 2048, cascade off / on / on / off.
        reps, n = CASCADE_LOOP
        ids, wts = payload(n)
        runs = []
        spans = ("cascade.stage1", "cascade.prune", "cascade.stage2")
        for label in ("off", "on", "on", "off"):
            t0 = request_trace.snapshot()
            lat = [predict(label, ids, wts)[2] for _ in range(reps)]
            t1 = request_trace.snapshot()
            run = {"stack": label, **_percentiles(lat)}
            if label == "on":
                for sp in spans:
                    a, b = t0.get(sp, {"total_ms": 0.0, "count": 0}), t1[sp]
                    run[f"{sp}_mean_ms"] = (b["total_ms"] - a["total_ms"]) / (b["count"] - a["count"])
            runs.append(run)
        out["loop"] = runs
        on_runs = [r for r in runs if r["stack"] == "on"]
        out["stage_means_ms"] = {sp: statistics.mean(r[f"{sp}_mean_ms"] for r in on_runs)
                                 for sp in spans}
        out["survivor_buckets"] = impl.cascade_stats()["survivor_buckets"]
        log(f"cascade: {reps} Predicts of n = {n} each, off / on / on / off: "
            + "; ".join(f"{r['stack']} p50 {r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms"
                        for r in runs)
            + "; stage means " + ", ".join(f"{sp} {v:.3f} ms"
                                           for sp, v in out["stage_means_ms"].items())
            + f"; survivor_buckets {out['survivor_buckets']} ({name})")

        # 5. Stage 1 unloaded: a full stage-2 pass answers, provenance all 2.
        f0 = casc.snapshot()["fallbacks"]
        impl.registry.unload(casc.stage1_model)
        ids, wts = payload(1000)
        got, stage, _ = predict("on", ids, wts)
        if stage is None or not (stage == STAGE2).all() or casc.snapshot()["fallbacks"] != f0 + 1:
            fail(f"cascade: with stage 1 unloaded the answer's provenance is {stage} and "
                 f"fallbacks moved {casc.snapshot()['fallbacks'] - f0}")
        if not np.array_equal(got, predict("off", ids, wts)[0]):
            fail("cascade: the fallback pass lost the plane-off bits")
        log("cascade: stage 1 unloaded -> the Predict answers OK with a full pass, provenance "
            "all 2, fallbacks + 1, the plane-off bits")
    finally:
        for stop in stops:
            stop()
        for ch in chans:
            ch.close()
        for server in servers:
            server.stop(grace=1).wait()
        for b in batchers:
            b.stop()
    return out


UTIL_LOOP = (4, 250, 1000)  # client processes (one client each), Predicts each, candidates
UTIL_CAPTURE_S = 1.0  # POST /profilez/start?seconds=
UTIL_SUM_TOL = 0.02  # the waterfall's components against its wall
# The cost loop's runs: both planes off / on / on / off, then each alone.
UTIL_COST_RUNS = ("off", "on", "on", "off", "utilization", "quality", "quality", "utilization")
UTIL_COST_PER_CLIENT = 60  # Predicts per client process in each cost run
UTIL_QUALITY_TOML = ("\n[quality]\nwindow_seconds = 2.0\nslices = 4\n"
                     "drift_check_interval_s = 0.25\n")
UTIL_DRIFT = (10, 50)  # drift Predicts (n = UTIL_LOOP[2]), the top rows they repeat
UTIL_LABELS = (4, 250)  # labelled Predicts, rows labelled per Predict
SKETCH_BINS = 50  # [quality] bins over [range_lo, range_hi] = [0, 1] (the defaults)


def _sketch_bins(scores) -> "np.ndarray":
    """The quality sketch's bin counts of `scores`, computed as the
    server's ScoreSketch bins them (float64, floor over the bin width,
    clipped into the edge bins)."""
    import numpy as np

    s = np.asarray(scores, dtype=np.float64).ravel()
    idx = np.clip(np.floor((s - 0.0) / (1.0 / SKETCH_BINS)).astype(np.int64), 0, SKETCH_BINS - 1)
    return np.bincount(idx, minlength=SKETCH_BINS)


def _loop_client(k, jobs, barrier, results) -> None:
    """One client process of the utilization phase's closed loop (started
    with spawn, kept for the phase): per job (port, serialized Predict,
    Predicts), one channel, the Predicts back to back after the barrier.
    Puts (latencies ms, the sketch bins of every returned score, scores
    returned, end time) or ("error", text) on `results`; None ends it."""
    import traceback

    try:
        import grpc

        from distributed_tf_serving_tpu_torch import codec
        from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    except BaseException:  # noqa: BLE001 — the parent fails the phase with it
        results.put(("error", traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            return
        port, req, per_client = job
        try:
            ch = _channel(port)
            call = ch.unary_unary("/tensorflow.serving.PredictionService/Predict",
                                  response_deserializer=apis.PredictResponse.FromString)
            grpc.channel_ready_future(ch).result(timeout=60)
            barrier.wait(timeout=120)
            lat, bins, n = [], None, 0
            for _ in range(per_client):
                t0 = time.perf_counter()
                resp = call(req, timeout=60)
                lat.append((time.perf_counter() - t0) * 1e3)
                got = codec.to_ndarray(resp.outputs["prediction_node"])
                b = _sketch_bins(got)
                bins = b if bins is None else bins + b
                n += got.shape[0]
            ch.close()
            results.put((lat, bins.tolist(), n, time.time()))
        except BaseException:  # noqa: BLE001 — the parent fails the phase with it
            results.put(("error", traceback.format_exc()))


class _LoopClients:
    """UTIL_LOOP[0] spawned client processes, one closed-loop client each,
    reused across the phase's loops (a spawn costs seconds of imports)."""

    def __init__(self, procs: int):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.results = ctx.Queue()
        self.barrier = ctx.Barrier(procs + 1)
        self.jobs = [ctx.Queue() for _ in range(procs)]
        self.procs = [ctx.Process(target=_loop_client, daemon=True,
                                  args=(k, self.jobs[k], self.barrier, self.results))
                      for k in range(procs)]
        for p in self.procs:
            p.start()

    def run(self, port: int, reqs: list[bytes], per_client: int, started=None) -> dict:
        """Client k sends reqs[k] per_client times; p50 / p99 / QPS over the
        wall time from the barrier to the last client's end, the sketch bins
        of every score returned. `started` (an Event) is set at the
        barrier."""
        import queue

        import numpy as np

        for q, req in zip(self.jobs, reqs):
            q.put((port, req, per_client))
        self.barrier.wait(timeout=180)
        t0 = time.time()
        if started is not None:
            started.set()
        lat, bins, n, ends = [], np.zeros(SKETCH_BINS, np.int64), 0, []
        for _ in self.procs:
            try:
                got = self.results.get(timeout=600)
            except queue.Empty:
                fail("utilization: a client process gave no result in 600 s")
            if got[0] == "error":
                fail(f"utilization: a client process failed: {got[1]}")
            lat.extend(got[0])
            bins += np.asarray(got[1], np.int64)
            n += got[2]
            ends.append(got[3])
        wall = max(ends) - t0
        return {**_percentiles(lat), "qps": len(lat) / wall, "wall_s": wall, "bins": bins,
                "scores": n}

    def close(self) -> None:
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(5)


def _trace_kernels(path: str) -> tuple[dict, float]:
    """A torch.profiler Chrome trace's kernel events: launches per kernel
    name, and the union of their intervals (s)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    names: dict = {}
    spans = []
    for e in events:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            names[e["name"]] = names.get(e["name"], 0) + 1
            spans.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
    spans.sort()
    busy, end = 0.0, -math.inf
    for t0, t1 in spans:
        if t1 <= end:
            continue
        busy += t1 - max(t0, end)
        end = t1
    return names, busy / 1e6


def _annotated(node, message: str) -> bool:
    """Whether a /tracez body holds a span annotated `message`."""
    if isinstance(node, dict):
        if any(a.get("message") == message for a in node.get("annotations", ()) or ()
               if isinstance(a, dict)):
            return True
        return any(_annotated(v, message) for v in node.values())
    if isinstance(node, list):
        return any(_annotated(v, message) for v in node)
    return False


def phase_utilization(dev, name: str, step_table: str) -> dict:
    """The utilization and quality planes on the card: the CLI server on
    configs/latency.toml (bf16 fused serve, seed-0 weights) with
    --utilization --quality --tracing --rest-port and [utilization]
    calibration_file = the serving phase's per-bucket device step
    (`step_table`), driven by client processes; then the planes' cost on an
    in-process stack of the same configuration (plane off / on / on / off).
    Checks in the docstring of the module."""
    import glob
    import tempfile
    import threading

    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server
    from distributed_tf_serving_tpu_torch.train.data import auc
    from distributed_tf_serving_tpu_torch.utils.config import (
        QualityConfig,
        UtilizationConfig,
        load_config,
    )

    out: dict = {"card": name, "calibration_file": step_table}
    loaded = load_config(os.path.join(HERE, "configs", "latency.toml"))
    cfg, model_cfg = loaded["server"], loaded["model"]
    fields = model_cfg.num_fields
    procs, per_client, n = UTIL_LOOP
    rng = np.random.RandomState(SEED + 17)
    payloads = [(rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
                 rng.rand(n, fields).astype(np.float32)) for _ in range(procs)]
    reqs = [_request(*p).SerializeToString() for p in payloads]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_util_")
    toml = os.path.join(HERE, "chiprun_out", "utilization.toml")
    with open(os.path.join(HERE, "configs", "latency.toml")) as f:
        text = f.read()
    with open(toml, "w") as f:
        f.write(text + f"\n[utilization]\ncalibration_file = {json.dumps(step_table)}\n"
                f"profile_dir = {json.dumps(os.path.join(tmp, 'profiles'))}\n"
                + UTIL_QUALITY_TOML
                + f"reference_file = {json.dumps(os.path.join(tmp, 'quality_reference.json'))}\n")
    clients = _LoopClients(procs)
    sent = {"bins": np.zeros(SKETCH_BINS, np.int64), "scores": 0}

    def tally(res):
        sent["bins"] += res["bins"]
        sent["scores"] += res["scores"]

    rest_port = _free_port()
    log_path = os.path.join(HERE, "chiprun_out", "utilization_server.log")
    proc = logf = http = ch = None
    try:
        proc, port, logf = _start_cli(
            ["--config", toml, "--utilization", "--quality", "--tracing",
             "--rest-port", str(rest_port)], log_path)
        _wait_port(rest_port, proc)
        http = _Http(rest_port)
        ch = _channel(port)
        from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub

        stub = PredictionServiceStub(ch)

        def predict(ids, wts, metadata=None):
            got = _scores_of(stub.Predict(_request(ids, wts), timeout=60, metadata=metadata))
            sent["bins"] += _sketch_bins(got)
            sent["scores"] += got.shape[0]
            return got

        u0 = http.json("GET", "/utilz")
        if (not u0["enabled"] or not u0["calibrated"] or u0["batches"] != 0
                or not u0["device"].startswith("cuda:")):
            fail(f"utilization: the CLI server's ledger is {u0}")
        b0 = http.json("GET", "/monitoring?section=metrics")["metrics"]["batcher"]["batches"]

        # 1. The closed loop, read over its own window.
        time.sleep(0.3)
        t0 = time.perf_counter()
        loop = clients.run(port, reqs, per_client)
        tally(loop)
        window = time.perf_counter() - t0 + 0.1
        u1 = http.json("GET", f"/utilz?window={window:.3f}")
        b1 = http.json("GET", "/monitoring?section=metrics")["metrics"]["batcher"]["batches"]
        wf = u1["waterfall"]
        comps = wf["components_s"]
        idle = {k: v for k, v in comps.items() if k.startswith("idle_")}
        bad = []
        if abs(wf["sum_s"] - wf["wall_s"]) > UTIL_SUM_TOL * wf["wall_s"]:
            bad.append(f"components sum {wf['sum_s']} against wall {wf['wall_s']}")
        if not wf["batches"] == u1["batches"] - u0["batches"] == b1 - b0:
            bad.append(f"batches: window {wf['batches']}, ledger {u1['batches'] - u0['batches']}, "
                       f"batcher {b1 - b0}")
        if u1["in_flight"] != 0:
            bad.append(f"in_flight {u1['in_flight']}")
        if any(v < 0 for v in comps.values()) or any(
                g["total_s"] < 0 for g in u1["idle_gaps"].values()):
            bad.append(f"a negative component {comps}")
        if (not 0 < wf["achieved_fraction_of_device_limit"] <= 1
                or wf["calibration"] != "device_step_table"):
            bad.append(f"achieved_fraction_of_device_limit "
                       f"{wf['achieved_fraction_of_device_limit']} ({wf['calibration']})")
        if bad:
            fail("utilization: the closed loop's waterfall: " + "; ".join(bad))
        out["loop"] = {k: v for k, v in loop.items() if k != "bins"}
        out["waterfall"] = wf
        out["idle_gaps"] = u1["idle_gaps"]
        out["max_in_flight"] = u1["max_in_flight"]
        share = {k: v / wf["wall_s"] for k, v in comps.items()}
        log(f"utilization: {procs} client processes x {per_client} Predicts of n = {n}: p50 "
            f"{loop['p50_ms']:.3f} ms p99 {loop['p99_ms']:.3f} ms qps {loop['qps']:.1f}; "
            f"/utilz over {wf['wall_s']:.3f} s: {wf['batches']} batches (= the batcher's), "
            f"components sum / wall {wf['sum_over_wall']:.6f}, busy {wf['busy_fraction']:.4f}, "
            f"achieved_fraction_of_device_limit {wf['achieved_fraction_of_device_limit']:.4f} "
            f"(calibrated), max in flight {u1['max_in_flight']}; shares "
            + ", ".join(f"{k} {v:.4f}" for k, v in share.items()) + f" ({name})")

        # 2. The deep capture during a second loop.
        started = threading.Event()
        res2: dict = {}

        def second():
            try:
                res2["loop"] = clients.run(port, reqs, per_client, started)
            except BaseException as exc:  # noqa: BLE001 — reported below
                res2["error"] = exc

        th = threading.Thread(target=second)
        th.start()
        if not started.wait(180):
            fail("utilization: the capture's loop did not start")
        time.sleep(0.3)
        t_post = time.perf_counter()
        info = http.json("POST", f"/profilez/start?seconds={UTIL_CAPTURE_S}")
        status, body = http.call("POST", f"/profilez/start?seconds={UTIL_CAPTURE_S}")
        if not info.get("device_trace"):
            fail(f"utilization: the capture has no device trace: {info}")
        if status != 409:
            fail(f"utilization: a second capture inside the window answered {status}: "
                 f"{body[:200]!r}")
        end = time.perf_counter() + 60
        while http.json("GET", "/profilez")["active"]:
            if time.perf_counter() > end:
                fail("utilization: the capture did not end within 60 s")
            time.sleep(0.02)
        u2 = http.json("GET", f"/utilz?window={time.perf_counter() - t_post:.3f}")
        th.join(600)
        if "error" in res2 or "loop" not in res2:
            fail(f"utilization: the capture's loop failed: {res2.get('error')}")
        tally(res2["loop"])
        traces = glob.glob(os.path.join(info["artifact_dir"], "trace_*.json"))
        if len(traces) != 1:
            fail(f"utilization: the capture wrote {traces} into {info['artifact_dir']}")
        kernels, kernel_busy = _trace_kernels(traces[0])
        with open(info["host_stacks"]) as f:
            stacks = json.load(f)
        ledger_busy = u2["waterfall"]["busy_fraction"] * u2["waterfall"]["wall_s"]
        threads = set(stacks["threads"])
        if not any("fused_serve_bf16_kernel" in k for k in kernels):
            fail(f"utilization: the capture's trace names no fused_serve_bf16_kernel: "
                 f"{sorted(kernels)[:10]}")
        if not {"batcher", "batch-dispatch"} <= threads or not any(
                t.startswith("batch-complete") for t in threads):
            fail(f"utilization: host_stacks.json names threads {sorted(threads)}")
        if not kernel_busy <= ledger_busy:
            fail(f"utilization: kernel busy {kernel_busy:.6f} s > the ledger's busy "
                 f"{ledger_busy:.6f} s over the capture")
        with open(os.path.join(HERE, "chiprun_out", "utilization_host_stacks.json"), "w") as f:
            json.dump(stacks, f, indent=1)
        # Where the dispatch thread was sampled: its three commonest stacks,
        # innermost three frames each.
        top = [(e["count"], " <- ".join(e["stack"].split(";")[:3]))
               for e in stacks["threads"].get("batch-dispatch", [])[:3]]
        fused = sum(v for k, v in kernels.items() if "fused_serve_bf16_kernel" in k)
        out["capture"] = {"seconds": UTIL_CAPTURE_S, "kernel_busy_s": kernel_busy,
                          "ledger_busy_s": ledger_busy, "ledger_window_s": u2["waterfall"]["wall_s"],
                          "ledger_batches": u2["waterfall"]["batches"],
                          "fused_serve_bf16_kernel_events": fused,
                          "kernel_events": kernels, "host_stack_samples": stacks["samples"],
                          "dispatch_top_stacks": top,
                          "loop": {k: v for k, v in res2["loop"].items() if k != "bins"}}
        log(f"utilization: /profilez capture of {UTIL_CAPTURE_S} s during the loop: device "
            f"trace on, {fused} fused_serve_bf16_kernel events; kernel busy "
            f"{kernel_busy * 1e3:.3f} ms against the ledger's busy {ledger_busy * 1e3:.3f} ms "
            f"over its {u2['waterfall']['wall_s']:.3f} s window ({u2['waterfall']['batches']} "
            f"batches; kernel / ledger {kernel_busy / ledger_busy:.4f}); a second POST 409; "
            f"host_stacks.json: {stacks['samples']} samples, threads {sorted(threads)[:6]}; "
            "batch-dispatch's commonest stacks: " + "; ".join(f"{c} x {st}" for c, st in top))

        # 3. Drift: pin, let the window turn over, then Predicts of the
        # rows with the highest scores of a loop payload, repeated.
        ids, wts = payloads[0]
        top = np.argsort(-predict(ids, wts), kind="stable")[:UTIL_DRIFT[1]]
        sel = np.resize(top, n)
        pinned = http.json("POST", "/qualityz/snapshot")
        if not pinned.get("pinned") or pinned["models"].get("DCN", 0) <= 0:
            fail(f"utilization: POST /qualityz/snapshot answered {pinned}")
        time.sleep(load_config(toml)["quality"].window_seconds + 0.5)
        for _ in range(UTIL_DRIFT[0]):
            predict(ids[sel], wts[sel])
        q = http.json("GET", "/qualityz")
        drift = q["models"]["DCN"]["drift"]
        ref = drift.get("reference") or {}
        if not (ref.get("psi", 0.0) > drift["threshold_psi"] and drift["exceeded"]
                and q["exemplars"]["marked"] >= 1):
            fail(f"utilization: no drift after the shifted Predicts: {drift}, exemplars "
                 f"{q['exemplars']}")
        tz = http.json("GET", "/tracez?limit=1000")
        if not _annotated(tz, "quality.drift"):
            fail("utilization: no /tracez span carries quality.drift")
        out["drift"] = {"reference": ref, "exemplars": q["exemplars"],
                        "pinned": pinned["models"]}
        log(f"utilization: pinned {pinned['models']}; {UTIL_DRIFT[0]} Predicts of the top "
            f"{UTIL_DRIFT[1]} rows: PSI {ref['psi']} (threshold {drift['threshold_psi']}), "
            f"JS {ref['js']}, exemplars {q['exemplars']}; /tracez holds a quality.drift span")

        # 4. Labels by trace id: the windowed AUC is train/data.auc's.
        lrng = np.random.RandomState(SEED + 18)
        pairs_s, pairs_l, items = [], [], []
        for i in range(UTIL_LABELS[0]):
            tid = "%032x" % lrng.randint(1, 1 << 62)
            ids, wts = payloads[i % procs]
            got = predict(ids, wts, metadata=(("traceparent", f"00-{tid}-{'%016x' % (i + 1)}-01"),))
            rows = np.arange(UTIL_LABELS[1])
            labels = (lrng.rand(rows.size) < got[rows]).astype(np.float64)
            pairs_s.append(got[rows].astype(np.float64))
            pairs_l.append(labels)
            items += [{"id": f"{tid}#{r}", "label": int(lab)} for r, lab in zip(rows, labels)]
        joined = http.json("POST", "/labelz", json.dumps({"labels": items}).encode())
        q = http.json("GET", "/qualityz")
        want = auc(np.concatenate(pairs_l), np.concatenate(pairs_s))
        lab = q["labels"]
        if (joined != {"joined": len(items), "orphaned": 0} or lab["window_pairs"] != len(items)
                or lab["auc"] is None or abs(lab["auc"] - round(want, 6)) > 1e-12):
            fail(f"utilization: /labelz answered {joined}; /qualityz labels {lab} against "
                 f"train/data.auc {want} over the same {len(items)} pairs")
        out["labels"] = {"pairs": len(items), "auc": lab["auc"], "auc_exact": want,
                         "calibration_error": lab["calibration"]["error"]}
        log(f"utilization: /labelz joined {len(items)} labels by trace id; windowed AUC "
            f"{lab['auc']} = train/data.auc {want:.9f} rounded to 6 places; calibration "
            f"error {lab['calibration']['error']}")

        # 5. The sketch holds every score the server answered, bin for bin.
        v = q["models"]["DCN"]["versions"]["1"]
        counts = np.asarray(v["histogram"]["counts"], np.int64)
        if v["count"] != sent["scores"] or not np.array_equal(counts, sent["bins"]):
            fail(f"utilization: /qualityz counts {v['count']} scores in bins "
                 f"{counts.tolist()}; the clients got {sent['scores']} in "
                 f"{sent['bins'].tolist()}")
        out["quality_scores"] = sent["scores"]
        log(f"utilization: /qualityz lifetime count {v['count']} = the scores returned, its "
            f"{SKETCH_BINS} bins = the clients' histogram of them (p50 {v['p50']}, p99 "
            f"{v['p99']})")

        # 6. The series.
        status, prom = http.call("GET", "/monitoring/prometheus/metrics")
        prom = prom.decode()
        lint = subprocess.run([sys.executable, os.path.join(HERE, "tools", "check_prom.py"), "-"],
                              input=prom, capture_output=True, text=True, timeout=60)
        util_lines = [ln for ln in prom.splitlines() if ln.startswith("dts_tpu_utilization_")]
        qual_lines = [ln for ln in prom.splitlines() if ln.startswith("dts_tpu_quality_")]
        count_line = (f'dts_tpu_quality_scores_total{{model_name="DCN",version="1"}} '
                      f'{sent["scores"]}')
        if (status != 200 or lint.returncode != 0 or len(util_lines) < 9
                or count_line not in qual_lines):
            fail(f"utilization: the exposition ({status}) has {len(util_lines)} utilization and "
                 f"{len(qual_lines)} quality lines, lint {lint.stdout[-300:]}")
        log(f"utilization: {len(util_lines)} dts_tpu_utilization_* and {len(qual_lines)} "
            "dts_tpu_quality_* lint-clean lines")
        http.close()
        http = None
        ch.close()
        ch = None
        rc = _stop_cli(proc, logf)
        proc = None
        if rc != 0:
            fail(f"utilization: the CLI server exited {rc} (log {log_path})")
        out["launches_server"] = _server_log(log_path)["shutdown"]

        # 7. The cost: the same loop in process, the planes off / on / on /
        # off (detached from the batcher for off).
        impl, batcher, _ = build_stack(
            cfg, model_cfg, "cuda", seed=SEED,
            utilization_config=UtilizationConfig(enabled=True, calibration_file=step_table),
            quality_config=QualityConfig(enabled=True, reference_file=""))
        server, sport = create_server(impl, "127.0.0.1:0")
        server.start()
        planes = (batcher.utilization, batcher.quality)
        attached = {"off": (None, None), "on": planes, "utilization": (planes[0], None),
                    "quality": (None, planes[1])}
        runs = []
        try:
            for i, label in enumerate(UTIL_COST_RUNS):
                batcher.utilization, batcher.quality = attached[label]
                if i == 1:  # the launch window: the two on runs
                    ck.reset_launches()
                    s0 = batcher.stats.batches
                r = clients.run(sport, reqs, UTIL_COST_PER_CLIENT)
                runs.append({"planes": label, **{k: v for k, v in r.items() if k != "bins"}})
                if i == 2:
                    launches = {f"{k}/{cd}": v for (k, cd), v in ck.launches.items()}
                    batches = batcher.stats.batches - s0
        finally:
            batcher.utilization, batcher.quality = planes
            server.stop(grace=1).wait()
            batcher.stop()
        others = {k: v for k, v in launches.items() if v and k != "fused_serve/bfloat16"}
        if launches.get("fused_serve/bfloat16", 0) != batches or others:
            fail(f"utilization: the on runs launched {launches} for {batches} batches (want "
                 "fused_serve/bfloat16 once per batch, nothing else)")
        out["launches"] = launches
        out["cost"] = runs
        qps = {label: statistics.mean(r["qps"] for r in runs if r["planes"] == label)
               for label in attached}
        out["qps_over_off"] = {label: v / qps["off"] for label, v in qps.items()}
        log("utilization: cost, the same loop in process, planes "
            + " / ".join(UTIL_COST_RUNS) + ": "
            + "; ".join(f"{r['planes']} p50 {r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms "
                        f"qps {r['qps']:.1f}" for r in runs)
            + "; mean QPS over off: " + ", ".join(f"{k} {v:.3f}"
                                                  for k, v in out["qps_over_off"].items())
            + f"; the on runs launched fused_serve/bfloat16 "
            f"{launches['fused_serve/bfloat16']} times ({batches} batches) ({name})")

        # 8. Each feed alone, on this host, with no other thread: one
        # observe of n scores, one ledger interval.
        monitor = QualityConfig(enabled=True, reference_file="").build()
        ledger = UtilizationConfig(enabled=True).build()
        scores = np.random.RandomState(SEED + 19).rand(n).astype(np.float32)
        reps = 2000
        t0 = time.perf_counter()
        for _ in range(reps):
            monitor.observe("DCN", 1, scores)
        observe_us = (time.perf_counter() - t0) / reps * 1e6
        t0 = time.perf_counter()
        for i in range(reps):
            ledger.depth_inc()
            ledger.note_batch(t0 + i * 1e-3, t0 + i * 1e-3 + 2e-4, t0 + i * 1e-3 + 5e-4,
                              bucket=2048, candidates=2 * n, d2h_wait_s=1e-4)
            ledger.depth_dec()
        batch_us = (time.perf_counter() - t0) / reps * 1e6
        out["feed_us"] = {"quality_observe": observe_us, "ledger_batch": batch_us}
        log(f"utilization: uncontended host cost: QualityMonitor.observe of {n} scores "
            f"{observe_us:.1f} us, the ledger's depth_inc + note_batch + depth_dec "
            f"{batch_us:.1f} us")
    finally:
        if http is not None:
            http.close()
        if ch is not None:
            ch.close()
        if proc is not None:
            _stop_cli(proc, logf)
        clients.close()
        torch.cuda.synchronize()
    return out



# The freshness phase: the continuous-freshness loop (train/, serving/lifecycle.py).
FRESH_TRAIN = (150, 512, 16384, 1e-2)  # the trainer CLI's v1: steps, batch, --id-space, rate
FRESH_CLIENTS = 4  # client processes, one closed-loop client each ([client] concurrent_num)
FRESH_N = 1000  # candidates per client Predict ([client] candidate_num)
FRESH_PAYLOADS = 7  # distinct payloads per client (odd: never in step with the 0.5 ramp)
FRESH_PROBE_EVERY = 10  # every 10th Predict of a client rides the probe lane
FRESH_LABELS = (4, 200)  # labelled Predicts per lane (probe, default), rows each
FRESH_SMALL_STEPS = 3  # f32 train steps of a small dcn_v2 on the card and on the CPU
FRESH_TRAIN_TOL = 1e-5  # their losses
FRESH_WAIT_S = 120.0  # bound on each wait of the phase
FRESH_POLL_S = 0.25  # --file-system-poll-wait-seconds of both servers
# fine_tune_interval_s of the publishing run: the server takes ~10 s from
# the controller's start to its REST port (the profiler's priming), so the
# clients get ~10 s of traffic before the first fine-tune; the next one is
# due this long after the first publish ends, after the phase is done.
FRESH_PUBLISH_S = 20.0
FRESH_AFTER_S = 3.0  # traffic kept up after v2's promotion
FRESH_FIXED = 2048  # rows of the payload pinned to a version (the top bucket)
FRESH_POISON_BIAS = 20.0  # added to the head's bias of the poisoned version
FRESH_LIFECYCLE = ("\n[quality]\nreference_file = \"\"\n"
                   "\n[lifecycle]\ntick_interval_s = 0.1\ncanary_probe_only_s = 1.0\n"
                   "canary_initial_fraction = 0.5\ncanary_step_dwell_s = 1.0\n"
                   "canary_max_fraction = 0.5\npromote_after_s = 2.0\n"
                   "min_canary_scores = 4000\nrollback_hold_s = 2.0\nfine_tune_steps = 100\n")
# The publishing run's rollback gates. Its fine-tune trains on the stream
# of another teacher (the publisher's per-round seed, as in the JAX
# package), so v2's scores move by design; the gates are set wide there so
# the run exercises promotion, and the PSI / AUC read at promotion are
# recorded. The rollback run keeps the defaults (PSI 0.5, AUC drop 0.05).
FRESH_PUBLISH_GATES = "rollback_psi = 4.0\nrollback_auc_drop = 0.5\n"


def _fresh_client(k, jobs, barrier, stop, results) -> None:
    """One client process of the freshness phase (spawned, kept for the
    phase): per job (port, serialized Predicts), one channel, Predicts back
    to back from the barrier until `stop` is set, every FRESH_PROBE_EVERY-th
    with `x-dts-criticality: probe`. Puts the records (send time on
    time.monotonic, ms, lane, status code, version answered) or ("error",
    text) on `results`; None ends it."""
    import traceback

    try:
        import grpc

        from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    except BaseException:  # noqa: BLE001 — the parent fails the phase with it
        results.put(("error", traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            return
        port, reqs = job
        try:
            ch = _channel(port)
            call = ch.unary_unary("/tensorflow.serving.PredictionService/Predict",
                                  response_deserializer=apis.PredictResponse.FromString)
            grpc.channel_ready_future(ch).result(timeout=60)
            barrier.wait(timeout=120)
            recs, i = [], 0
            while not stop.is_set():
                probe = i % FRESH_PROBE_EVERY == FRESH_PROBE_EVERY - 1
                md = (("x-dts-criticality", "probe"),) if probe else None
                t0 = time.monotonic()
                try:
                    resp = call(reqs[i % len(reqs)], timeout=60, metadata=md)
                    code, version = "OK", resp.model_spec.version.value
                except grpc.RpcError as e:
                    code, version = e.code().name, None
                recs.append((t0, (time.monotonic() - t0) * 1e3, "probe" if probe else "default",
                             code, version))
                i += 1
            ch.close()
            results.put(recs)
        except BaseException:  # noqa: BLE001 — the parent fails the phase with it
            results.put(("error", traceback.format_exc()))


class _FreshClients:
    """`procs` spawned client processes running `target`, reused for every
    server of a phase: start() releases them on a server, stop() ends their
    loops and returns every record."""

    def __init__(self, procs: int, target=None, label: str = "freshness"):
        import multiprocessing

        target = target or _fresh_client
        self.label = label
        ctx = multiprocessing.get_context("spawn")
        self.results = ctx.Queue()
        self.barrier = ctx.Barrier(procs + 1)
        self.stop_evt = ctx.Event()
        self.jobs = [ctx.Queue() for _ in range(procs)]
        self.procs = [ctx.Process(target=target, daemon=True,
                                  args=(k, self.jobs[k], self.barrier, self.stop_evt,
                                        self.results))
                      for k in range(procs)]
        for p in self.procs:
            p.start()

    def start(self, port: int, reqs: list[list[bytes]]) -> None:
        self.stop_evt.clear()
        for q, mine in zip(self.jobs, reqs):
            q.put((port, mine))
        self.barrier.wait(timeout=180)

    def stop(self) -> list:
        import queue

        self.stop_evt.set()
        recs = []
        for _ in self.procs:
            try:
                got = self.results.get(timeout=120)
            except queue.Empty:
                fail(f"{self.label}: a client process gave no result in 120 s")
            if got and got[0] == "error":
                fail(f"{self.label}: a client process failed: {got[1]}")
            recs.extend(got)
        return recs

    def close(self) -> None:
        self.stop_evt.set()
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(5)


def _lifecycle_wait(http, pred, what: str, proc) -> dict:
    """Poll GET /lifecyclez (every 50 ms) until pred(body); the body."""
    end = time.perf_counter() + FRESH_WAIT_S
    while True:
        body = http.json("GET", "/lifecyclez")
        if pred(body):
            return body
        if proc.poll() is not None:
            fail(f"freshness: the server exited with {proc.returncode} waiting for {what}")
        if time.perf_counter() > end:
            fail(f"freshness: no {what} within {FRESH_WAIT_S} s: {json.dumps(body)[:1500]}")
        time.sleep(0.05)


def _event(body: dict, event: str, **match) -> dict | None:
    for e in body["events"]:
        if e["event"] == event and all(e.get(k) == v for k, v in match.items()):
            return e
    return None


def _lifecycle_surfaces(http, label: str) -> dict:
    """/lifecyclez, /monitoring?section=lifecycle and the dts_tpu_lifecycle_*
    series must agree with the events: state one-hot, counters, stable and
    canary versions; the exposition must pass tools/check_prom.py. The three
    are separate reads, so a transition (or a tick) between them is read
    again, up to 5 times."""
    for attempt in range(5):
        lz = http.json("GET", "/lifecyclez")
        sec = http.json("GET", "/monitoring?section=lifecycle")["lifecycle"]
        status, data = http.call("GET", "/monitoring/prometheus/metrics")
        lz2 = http.json("GET", "/lifecyclez")
        if status != 200:
            fail(f"freshness {label}: /monitoring/prometheus/metrics answered {status}")
        lint = subprocess.run([sys.executable, os.path.join(HERE, "tools", "check_prom.py"),
                               "-"], input=data, capture_output=True, timeout=60)
        if lint.returncode != 0:
            fail(f"freshness {label}: tools/check_prom.py rejects the exposition: "
                 f"{lint.stdout.decode()[-500:]} {lint.stderr.decode()[-500:]}")
        series = {}
        for line in data.decode().splitlines():
            if line.startswith("dts_tpu_lifecycle_"):
                key, value = line.rsplit(" ", 1)
                series[key] = float(value)
        events = [e["event"] for e in lz["events"]]
        c = lz["counters"]
        want = {
            f'dts_tpu_lifecycle_state{{state="{lz["state"]}"}}': 1.0,
            "dts_tpu_lifecycle_promotes_total": float(events.count("promoted")),
            "dts_tpu_lifecycle_rollbacks_total": float(events.count("rolled_back")),
            "dts_tpu_lifecycle_publishes_total": float(events.count("published")),
            "dts_tpu_lifecycle_stable_version": float(lz["stable_version"] or 0),
            "dts_tpu_lifecycle_canary_version": float(lz["canary_version"] or 0),
            'dts_tpu_lifecycle_routed_total{target="canary"}': float(c["routed_canary"]),
            'dts_tpu_lifecycle_routed_total{target="stable"}': float(c["routed_stable"]),
            "dts_tpu_lifecycle_probe_routed_total": float(c["routed_probe"]),
            "dts_tpu_lifecycle_blacklisted_versions": float(len(lz["watcher"]["blacklisted"])),
        }
        bad = {k: (series.get(k), v) for k, v in want.items() if series.get(k) != v}
        if sum(v for k, v in series.items() if k.startswith("dts_tpu_lifecycle_state{")) != 1:
            bad["one-hot"] = {k: v for k, v in series.items() if "state{" in k}
        # Only the tick count and the state's age move while nothing happens.
        skip = ("state_age_s", "counters", "watcher")

        def same(a, b):
            return ({k: v for k, v in a.items() if k not in skip}
                    == {k: v for k, v in b.items() if k not in skip}
                    and {k: v for k, v in a["counters"].items() if k != "ticks"}
                    == {k: v for k, v in b["counters"].items() if k != "ticks"})

        if not same(sec, lz):
            bad["section"] = "differs from /lifecyclez"
        if not bad:
            return {"state": lz["state"], "series": len(series), "counters": c,
                    "reads": attempt + 1}
        if same(lz, lz2):
            break  # nothing moved between the reads: a real disagreement
        time.sleep(0.3)
    fail(f"freshness {label}: the surfaces disagree with the events: {bad}")


def _published_lines(path: str) -> list[dict]:
    """The server log's `lifecycle DCN published: {...}` records."""
    import re

    out = []
    with open(path) as f:
        for line in f:
            m = re.search(r"lifecycle DCN published: (\{.*\})$", line)
            if m:
                out.append(json.loads(m.group(1)))
    return out


def _lat_split(recs, t0: float, t1: float, after: float) -> dict:
    """p50 / p99 of the OK records sent inside [t0, t1), before t0, and
    from `after` on."""
    def pick(lo, hi):
        return _percentiles([r[1] for r in recs if r[3] == "OK" and lo <= r[0] < hi])

    return {"during": pick(t0, t1), "before": pick(-math.inf, t0),
            "after": pick(after, math.inf)}


def phase_freshness(dev, name: str) -> dict:
    """The continuous-freshness loop on the card, out of process: v1 from
    the trainer CLI, a server that fine-tunes it into v2, canaries and
    promotes it under client traffic, then a second server that rolls a
    poisoned version back. Checks in the docstring of the module."""
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch.cache.digest import row_label_keys
    from distributed_tf_serving_tpu_torch.interop.export import publish_version
    from distributed_tf_serving_tpu_torch.models import ModelConfig, build_model
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.train.checkpoint import load_servable, save_servable
    from distributed_tf_serving_tpu_torch.train.data import SyntheticCTRConfig, SyntheticCTRStream
    from distributed_tf_serving_tpu_torch.train.trainer import (
        init_state,
        make_train_step,
        prepare_batch,
        tree_map,
    )
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    out: dict = {"card": name}
    latency = os.path.join(HERE, "configs", "latency.toml")
    model_cfg = load_config(latency)["model"]
    fields, vocab = model_cfg.num_fields, model_cfg.vocab_size
    with open(latency) as f:
        text = f.read()
    clients = _FreshClients(FRESH_CLIENTS)  # spawned now: their imports overlap the training
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fresh_")
    base = os.path.join(tmp, "base")
    proc = logf = http = ch = None
    launches: dict = {}
    try:
        # 1. v1 from the trainer CLI on the card.
        steps, bs, id_space, lr = FRESH_TRAIN
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", f"{PKG}.train.trainer", "--out", os.path.join(base, "1"),
             "--steps", str(steps), "--batch-size", str(bs), "--num-fields", str(fields),
             "--vocab-size", str(vocab), "--embed-dim", str(model_cfg.embed_dim),
             "--id-space", str(id_space), "--learning-rate", str(lr)],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        with open(os.path.join(HERE, "chiprun_out", "freshness_trainer.log"), "w") as f:
            f.write(run.stdout + run.stderr)
        m = re.search(r"trained dcn_v2 (\d+) steps on (\S+): loss=([\d.]+) auc=([\d.]+) "
                      r"bayes_auc=([\d.]+) \((\d+) ex/s\)", run.stdout)
        if run.returncode != 0 or m is None:
            fail(f"freshness: the trainer CLI exited {run.returncode}: {run.stderr[-1500:]}")
        train = {"steps": int(m.group(1)), "device": m.group(2), "loss": float(m.group(3)),
                 "auc": float(m.group(4)), "bayes_auc": float(m.group(5)),
                 "examples_per_s": int(m.group(6)), "batch_size": bs, "id_space": id_space,
                 "learning_rate": lr,
                 "cli_wall_s": cli_s}
        if not train["device"].startswith("cuda") or not math.isfinite(train["loss"]):
            fail(f"freshness: the trainer CLI trained {train}")
        if not 0.5 < train["auc"] <= train["bayes_auc"]:
            fail(f"freshness: v1's held-out AUC {train['auc']} (Bayes {train['bayes_auc']})")
        out["train"] = train
        log(f"freshness: trainer CLI v1 ({fields} fields x {model_cfg.embed_dim}, vocab {vocab}, "
            f"dcn_v2 bf16, {steps} steps x {bs}, id space {id_space}, rate {lr}) on "
            f"{train['device']}: "
            f"{train['examples_per_s']} ex/s, final loss {train['loss']:.4f}, eval AUC "
            f"{train['auc']:.4f} (Bayes {train['bayes_auc']:.4f}), CLI wall {cli_s:.1f} s "
            f"({name})")

        # 2. Three f32 train steps of a small dcn_v2: the card against the CPU.
        small = ModelConfig(num_fields=10, embed_dim=8, mlp_dims=(32, 16), vocab_size=1 << 12,
                            num_cross_layers=2, compute_dtype="float32")
        smodel = build_model("dcn_v2", small)
        p0 = smodel.init(1)
        sstream = SyntheticCTRStream(SyntheticCTRConfig(num_fields=10, id_space=1 << 12, seed=1))
        losses = {}
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            state = init_state(tree_map(lambda t, d=d: t.to(d), p0), 1e-2)
            step = make_train_step(smodel)
            losses[where] = [float(step(state, prepare_batch(sstream.batch(256, i),
                                                             small.vocab_size, d))[1]["loss"])
                             for i in range(FRESH_SMALL_STEPS)]
        err = max(abs(a - b) for a, b in zip(losses["card"], losses["cpu"]))
        if err > FRESH_TRAIN_TOL:
            fail(f"freshness: f32 train steps card {losses['card']} against CPU "
                 f"{losses['cpu']}: {err} > {FRESH_TRAIN_TOL}")
        out["small_steps"] = {"losses": losses, "max_abs_err": err, "tol": FRESH_TRAIN_TOL}
        log(f"freshness: {FRESH_SMALL_STEPS} f32 train steps (dcn_v2 10 x 8) card / CPU losses "
            f"{losses['card']} / {losses['cpu']}, max |d| {err:.2e} (tol {FRESH_TRAIN_TOL})")

        # The clients' payloads: the stream the model learns from, 7 per client.
        pstream = SyntheticCTRStream(SyntheticCTRConfig(num_fields=fields, seed=SEED + 23))
        payloads = [[pstream.batch(FRESH_N, k * FRESH_PAYLOADS + j)
                     for j in range(FRESH_PAYLOADS)] for k in range(FRESH_CLIENTS)]
        reqs = [[_request(p["feat_ids"], p["feat_wts"]).SerializeToString() for p in mine]
                for mine in payloads]
        # The pinned payload fills the top bucket alone, so it never shares
        # a batch.
        fixed = pstream.batch(FRESH_FIXED, 10_000)

        def pinned(version: int):
            req = _request(fixed["feat_ids"], fixed["feat_wts"])
            req.model_spec.version.value = version
            resp = stub.Predict(req, timeout=60)
            if resp.model_spec.version.value != version:
                fail(f"freshness: a Predict pinned to v{version} answered "
                     f"v{resp.model_spec.version.value}")
            return _scores_of(resp)

        def start(label: str, publish_s: float, gates: str):
            toml = os.path.join(HERE, "chiprun_out", f"freshness_{label}.toml")
            with open(toml, "w") as f:
                f.write(text + FRESH_LIFECYCLE + gates + f"fine_tune_interval_s = {publish_s}\n")
            rest_port = _free_port()
            log_path = os.path.join(HERE, "chiprun_out", f"freshness_{label}_server.log")
            p, port, lf = _start_cli(
                ["--config", toml, "--model-base-path", base, "--lifecycle", "--rest-port",
                 str(rest_port), "--file-system-poll-wait-seconds", str(FRESH_POLL_S)],
                log_path)
            _wait_port(rest_port, p)
            return p, port, lf, log_path, _Http(rest_port)

        def server_launches(log_path: str, label: str) -> dict:
            srv = _server_log(log_path)
            if srv["shutdown"] is None:
                fail(f"freshness {label}: the server logged no launch counts at shutdown")
            counts = [c.get("fused_serve/bfloat16", 0) for c in srv["changes"]]
            counts.append(srv["shutdown"].get("fused_serve/bfloat16", 0))
            if not counts[0] > 0 or any(b < a for a, b in zip(counts, counts[1:])):
                fail(f"freshness {label}: fused_serve/bfloat16 launches at each version change "
                     f"and at shutdown {counts}")
            for k, v in srv["shutdown"].items():
                launches[k] = launches.get(k, 0) + v
            return {"at_changes": counts[:-1], "at_shutdown": srv["shutdown"]}

        # 3. The publishing run: v1 is fine-tuned into v2 inside the server.
        proc, port, logf, log_a, http = start("publish", FRESH_PUBLISH_S, FRESH_PUBLISH_GATES)
        ch = _channel(port)
        stub = PredictionServiceStub(ch)
        lz = http.json("GET", "/lifecyclez")
        if not (lz.get("enabled") and lz["state"] == "idle" and lz["stable_version"] == 1):
            fail(f"freshness: the publishing server's lifecycle at start: {lz}")
        if not http.json("GET", "/qualityz").get("enabled"):
            fail("freshness: --lifecycle did not arm the quality plane")
        before = pinned(1)
        clients.start(port, reqs)
        lz = _lifecycle_wait(http, lambda s: s["state"] == "canary" and s["canary_version"] == 2,
                             "canary of v2", proc)
        after = pinned(1)  # v1 is pinned by the controller while v2 is the canary
        if before.tobytes() != after.tobytes():
            fail(f"freshness: v1's scores moved across the fine-tune (max |d| "
                 f"{float(np.abs(before - after).max())})")
        v2_scores = pinned(2)
        # Labelled Predicts, joined by row digest: held-out rows and labels
        # of the stream v1 was trained on (the trainer CLI's seed 0).
        lstream = SyntheticCTRStream(SyntheticCTRConfig(num_fields=fields,
                                                        id_space=min(id_space, vocab)))
        label_items, label_versions = [], {"probe": [], "default": []}
        per_lane, rows = FRESH_LABELS
        for j in range(2 * per_lane):
            lane = "probe" if j < per_lane else "default"
            b = lstream.batch(rows, 3_000_000 + j)
            resp = stub.Predict(_request(b["feat_ids"], b["feat_wts"]), timeout=60,
                                metadata=(("x-dts-criticality", "probe"),) if lane == "probe"
                                else None)
            label_versions[lane].append(resp.model_spec.version.value)
            keys = row_label_keys({"feat_ids": b["feat_ids"], "feat_wts": b["feat_wts"]})
            label_items += [{"id": key, "label": float(y)} for key, y in zip(keys, b["labels"])]
        status, body = http.call("POST", "/labelz", json.dumps({"labels": label_items}).encode())
        joined = json.loads(body) if status == 200 else {}
        if joined.get("joined") != len(label_items):
            fail(f"freshness: /labelz answered {status} {body[:300]!r} for "
                 f"{len(label_items)} labels")
        if any(v != 2 for v in label_versions["probe"]):
            fail(f"freshness: probe-lane label Predicts answered {label_versions['probe']}")
        ramp0 = _lifecycle_wait(http, lambda s: s["state"] != "canary"
                                or s["canary_fraction"] == 0.5, "the 0.5 ramp", proc)
        lz = _lifecycle_wait(http, lambda s: s["counters"]["promotes"] >= 1
                             and s["state"] == "idle", "promotion of v2", proc)
        time.sleep(FRESH_AFTER_S)
        recs_a = clients.stop()
        if ramp0["state"] != "canary":
            fail(f"freshness: v2 left the canary before the ramp was seen: {ramp0['events']}")
        surfaces_a = _lifecycle_surfaces(http, "publish")
        pubs = _published_lines(log_a)
        ev_pub = _event(lz, "published", version=2)
        ev_can = _event(lz, "canary_started", canary=2)
        ev_pro = _event(lz, "promoted", version=2)
        if not (pubs and ev_pub and ev_can and ev_pro and pubs[0]["version"] == 2):
            fail(f"freshness: the publishing run's events {lz['events']} and log {pubs}")
        ft = pubs[0]
        c_end = lz["counters"]
        # The routes, as the clients saw them, inside the controller's
        # windows (edges shrunk by 50 ms: a request is routed when it is
        # resolved, a little after it is sent): in the probe-only phase
        # the probe lane answers from v2 and the default lane from v1; at
        # the 0.5 ramp the default lane alternates, so its v2 and v1
        # answers differ by at most the requests in flight at the edges.
        probe_only = 1.0  # FRESH_LIFECYCLE canary_probe_only_s
        t_can, t_pro = ev_can["t"], ev_pro["t"]

        def answers(lane, lo, hi):
            got = [r[4] for r in recs_a if r[2] == lane and r[3] == "OK" and lo <= r[0] < hi]
            return got.count(2), len(got) - got.count(2)

        fails_a = [r for r in recs_a if r[3] != "OK"]
        ph_probe = answers("probe", t_can + 0.05, t_can + probe_only - 0.05)
        ph_default = answers("default", t_can + 0.05, t_can + probe_only - 0.05)
        rp_probe = answers("probe", t_can + probe_only + 0.05, t_pro - 0.05)
        rp_default = answers("default", t_can + probe_only + 0.05, t_pro - 0.05)
        # Before the canary's first tick the registry's latest-version
        # default already serves a hot-loaded v2 (as in the JAX package):
        # the default-lane answers from v2 sent before canary_started.
        early = sum(1 for r in recs_a if r[2] == "default" and r[4] == 2 and r[0] < t_can)
        dc = (c_end["routed_canary"] - c_end["routed_probe"]
              - (ramp0["counters"]["routed_canary"] - ramp0["counters"]["routed_probe"]))
        ds = c_end["routed_stable"] - ramp0["counters"]["routed_stable"]
        bad = []
        if fails_a:
            bad.append(f"{len(fails_a)} failed Predicts: {sorted({r[3] for r in fails_a})}")
        if ph_probe[1] or ph_default[0] or not ph_probe[0] or not ph_default[1]:
            bad.append(f"in the probe-only phase probe v2/v1 {ph_probe}, default v2/v1 "
                       f"{ph_default}")
        if rp_probe[1] or abs(rp_default[0] - rp_default[1]) > FRESH_CLIENTS + 1 \
                or sum(rp_default) < 20:
            bad.append(f"at the 0.5 ramp probe v2/v1 {rp_probe}, default v2/v1 {rp_default}")
        if abs(dc - ds) > 1 or dc + ds < 20:
            bad.append(f"the controller's routes at the 0.5 ramp: {dc} canary / {ds} stable")
        if bad:
            fail("freshness: the publishing run: " + "; ".join(bad))
        default_share = rp_default[0] / sum(rp_default)
        # p50 / p99 while the fine-tune trains, while it publishes, and before it.
        # "after": from 0.5 s past the promotion (v2 alone, no training).
        train_lat = _lat_split(recs_a, ft["t0"], ft["t0"] + ft["wall_s"], t_pro + 0.5)
        publish_lat = _lat_split(recs_a, ft["t0"], ft["t1"], t_pro + 0.5)
        out["publish"] = {
            "fine_tune": {"steps": ft["steps"], "wall_s": ft["wall_s"],
                          "steps_per_s": ft["steps"] / ft["wall_s"], "loss": ft["loss"],
                          "publish_s": ft["t1"] - ft["t0"]},
            "latency_training": train_lat, "latency_publish": publish_lat,
            "publish_to_canary_s": ev_can["t"] - ev_pub["t"],
            "canary_to_promote_s": ev_pro["t"] - ev_can["t"],
            "requests": len(recs_a), "failed": 0, "counters": c_end,
            "controller_ramp": {"canary": dc, "stable": ds, "share": dc / (dc + ds)},
            "clients_probe_phase": {"probe_v2_v1": ph_probe, "default_v2_v1": ph_default},
            "clients_ramp": {"probe_v2_v1": rp_probe, "default_v2_v1": rp_default,
                             "default_share": default_share},
            "default_v2_before_canary": early,
            "labels": {"joined": joined, "versions": label_versions,
                       "last_judgment": lz.get("last_judgment")},
            "surfaces": surfaces_a,
        }
        log(f"freshness: in-server fine-tune v1 -> v2: {ft['steps']} steps (batch 256) in "
            f"{ft['wall_s']:.3f} s = {ft['steps'] / ft['wall_s']:.1f} steps/s, loss "
            f"{ft['loss']:.4f}, publish (train + save + commit) {ft['t1'] - ft['t0']:.3f} s; "
            f"publish -> canary {ev_can['t'] - ev_pub['t']:.3f} s, canary -> promote "
            f"{ev_pro['t'] - ev_can['t']:.3f} s ({name})")
        def pp(d):
            return (f"{d.get('p50_ms', float('nan')):.3f} / {d.get('p99_ms', float('nan')):.3f} "
                    f"ms ({d['requests']} requests)")

        log(f"freshness: Predict (n = {FRESH_N}, {FRESH_CLIENTS} client processes) p50 / p99 "
            f"while training {pp(train_lat['during'])}, before it {pp(train_lat['before'])}, "
            f"after v2's promotion {pp(train_lat['after'])}; during the whole publish "
            f"{publish_lat['during'].get('p50_ms', float('nan')):.3f} / "
            f"{publish_lat['during'].get('p99_ms', float('nan')):.3f} ms; {len(recs_a)} "
            f"Predicts, 0 failed; probe-only phase: probe {ph_probe[0]} on v2, default "
            f"{ph_default[1]} on v1; at the 0.5 ramp the clients' default lane {rp_default[0]} "
            f"v2 / {rp_default[1]} v1 (share {default_share:.4f}), the controller's "
            f"{dc} / {ds} (share {dc / (dc + ds):.4f}); {early} default-lane Predicts "
            f"answered v2 before canary_started; v1 pinned bit-identical across the "
            f"fine-tune ({name})")
        http.close()
        ch.close()
        http = ch = None
        rc = _stop_cli(proc, logf)
        proc = None
        if rc != 0:
            fail(f"freshness: the publishing server exited {rc} (log {log_a})")
        out["publish"]["launches"] = server_launches(log_a, "publish")

        # v2, read back from its checkpoint onto the card: the fused serve
        # kernel against its plain version and against the server's answer.
        sv2 = load_servable(os.path.join(base, "2"), device=dev)
        sw = ck.prepare_serve_weights(sv2.params, sv2.model.config)
        ids = torch.from_numpy(fixed["feat_ids"] % vocab).to(torch.int32).to(dev)
        wts = torch.from_numpy(fixed["feat_wts"]).to(dev).to(torch.bfloat16)
        before_ref = dict(ck.launches)
        got = ck.fused_serve(ids, wts, sw)["prediction_node"]
        ref = ck.fused_serve_reference(ids, wts, sw)["prediction_node"]
        torch.cuda.synchronize()
        ref_launches = {f"{k}/{cd}": v - before_ref[(k, cd)] for (k, cd), v in ck.launches.items()
                        if v != before_ref[(k, cd)]}
        err = (got - ref).abs().max().item()
        served_err = float(np.abs(got.float().cpu().numpy() - v2_scores).max())
        if err > SERVE_TOL["bfloat16"] or served_err > APPLY_TOL:
            fail(f"freshness: v2's fused serve kernel against its plain version {err} (tol "
                 f"{SERVE_TOL['bfloat16']}), against the server's answer {served_err}")
        out["v2_kernel"] = {"max_abs_err": err, "tol": SERVE_TOL["bfloat16"],
                            "served_max_abs_err": served_err, "reference_launches": ref_launches}
        judged = lz.get("last_judgment") or {}
        log(f"freshness: v2's judgment at promotion: verdict {judged.get('verdict')}, pair PSI "
            f"{(judged.get('pair') or {}).get('psi')} over {(judged.get('pair') or {}).get('bins')} "
            f"bins, label AUC stable / canary {(judged.get('auc') or {}).get('stable')} / "
            f"{(judged.get('auc') or {}).get('canary')} ({joined['joined']} labels joined)")
        log(f"freshness: v2 from disk, fused_serve_bf16 at n = {FRESH_FIXED} against its plain "
            f"version max |d| {err:.2e} (tol {SERVE_TOL['bfloat16']}), against the server's "
            f"v2 answer {served_err:.2e}")
        del sv2, sw

        # 4. The rollback run: the publisher off, a poisoned version from outside.
        proc, port, logf, log_b, http = start("rollback", 0.0, "")
        lz0 = http.json("GET", "/lifecyclez")
        stable = lz0["stable_version"]
        if lz0["state"] != "idle" or stable is None or stable < 2:
            fail(f"freshness: the rollback server's lifecycle at start: {lz0}")
        clients.start(port, reqs)
        src = load_servable(os.path.join(base, str(stable)), device="cpu")
        poisoned = tree_map(lambda t: t.clone(), src.params)
        poisoned["out"]["b"] = poisoned["out"]["b"] + FRESH_POISON_BIAS
        version, _ = publish_version(base, lambda d: save_servable(
            d, dataclasses.replace(src, params=poisoned, version=stable + 1), kind="dcn_v2"),
            at_least=stable + 1)
        t_pub = time.monotonic()
        # The controller counts the rollback before it retires the version
        # and records the `rolled_back` transition (as the JAX package's
        # does): wait for the transition, so the snapshot is whole.
        lz = _lifecycle_wait(http, lambda s: s["counters"]["rollbacks"] >= 1
                             and _event(s, "rolled_back", version=version) is not None,
                             f"the rollback of v{version}", proc)
        time.sleep(3 * FRESH_POLL_S)  # reconcile passes over the still-ready directory
        lz_after = http.json("GET", "/lifecyclez")
        status, rb = http.call("POST", "/lifecyclez/rollback")
        recs_b = clients.stop()
        surfaces_b = _lifecycle_surfaces(http, "rollback")
        ev_can = _event(lz, "canary_started", canary=version)
        ev_rb = _event(lz, "rolled_back", version=version)
        fails_b = [r for r in recs_b if r[3] != "OK"]
        early_b = sum(1 for r in recs_b if r[2] == "default" and r[4] == version
                      and ev_can is not None and r[0] < ev_can["t"])
        w = lz_after["watcher"]
        bad = []
        if fails_b:
            bad.append(f"{len(fails_b)} failed Predicts: {sorted({r[3] for r in fails_b})}")
        if not (ev_can and ev_rb and lz["rolled_back_version"] == version
                and (lz["last_rollback"] or {}).get("reason") == "psi"):
            bad.append(f"events {lz['events']}, last_rollback {lz['last_rollback']}")
        if version not in w["blacklisted"] or version in w["loaded"] \
                or version in lz_after["versions_loaded"] or version not in w["on_disk_ready"]:
            bad.append(f"after the reconcile passes: watcher {w}")
        if status != 409:
            bad.append(f"POST /lifecyclez/rollback with no canary answered {status}: {rb[:200]!r}")
        # The judgment rests on evidence: the pair PSI past the default gate
        # over at least min_canary_scores of the canary's scores. (The probe
        # lane need not have reached it: until the controller's first tick
        # the registry's latest default serves the new version, as in the
        # JAX package, and those scores can decide the first judgment.)
        pair = (lz["last_rollback"] or {}).get("pair") or {}
        if not (pair.get("psi", 0) >= 0.5 and (pair.get("counts") or [0, 0])[1] >= 4000):
            bad.append(f"the rollback's evidence: {pair}")
        if bad:
            fail(f"freshness: the rollback run (v{version}): " + "; ".join(bad))
        out["rollback"] = {
            "version": version, "stable": stable,
            "publish_to_canary_s": ev_can["t"] - t_pub,
            "canary_to_rollback_s": ev_rb["t"] - ev_can["t"],
            "publish_to_rollback_s": ev_rb["t"] - t_pub,
            "pair": lz["last_rollback"]["pair"], "requests": len(recs_b), "failed": 0,
            "default_poisoned_before_canary": early_b,
            "counters": lz["counters"], "surfaces": surfaces_b,
        }
        log(f"freshness: poisoned v{version} (head bias +{FRESH_POISON_BIAS}) published -> "
            f"canary {ev_can['t'] - t_pub:.3f} s -> rolled back {ev_rb['t'] - ev_can['t']:.3f} s "
            f"(pair PSI {lz['last_rollback']['pair']['psi']:.2f}), retired + blacklisted, not "
            f"reloaded after {3 * FRESH_POLL_S:.2f} s of reconcile passes; POST "
            f"/lifecyclez/rollback 409; {len(recs_b)} Predicts, 0 failed, {early_b} default-lane "
            f"answers from v{version} before canary_started ({name})")
        http.close()
        http = None
        rc = _stop_cli(proc, logf)
        proc = None
        if rc != 0:
            fail(f"freshness: the rollback server exited {rc} (log {log_b})")
        out["rollback"]["launches"] = server_launches(log_b, "rollback")
        if launches.get("fused_serve/bfloat16", 0) == 0:
            fail(f"freshness: the servers launched {launches}")
        out["launches"] = launches
        log(f"freshness: launches_freshness (both servers, start to exit) {launches}")
    finally:
        if http is not None:
            http.close()
        if ch is not None:
            ch.close()
        if proc is not None:
            _stop_cli(proc, logf)
        clients.close()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.synchronize()
    return out


REC_CLIENTS = 4  # client processes, one closed-loop client each ([client] concurrent_num)
REC_N = 1000  # candidates per client Predict ([client] candidate_num)
REC_SECTION = ("\n[recovery]\nenabled = true\nwatchdog_interval_s = 0.1\n"
               "wedge_quarantine_s = 1.0\n")
# The keyless device_lost rule: count 1 at rate 0.002, which at seed 0
# fires at its 659th draw (one draw per batch member), a few seconds into
# the clients' load, so the loop has a before, a during and an after.
REC_KEYLESS = "device_lost=error,code=UNAVAILABLE,count=1,rate=0.002"
REC_BLOCK_S = 0.5  # the bisection's blocker holds its dispatch stage (below the 1 s trip)
REC_WEDGE_S = 3.0  # the batcher.dispatch wedge's hold (its delay cap)
REC_STALL_S = 2.0  # each dispatch stage of the SIGTERM payload stalls this long (> the 1 s trip)
REC_AFTER_S = 2.0  # the clients' load kept up after the cycle
REC_RETRY_S = 0.005  # a refused client waits this long before it retries
REC_WAIT_S = 60.0  # bound on each wait of the phase
REC_CHILD_S = 180.0  # bound on the sticky-error child, start to exit
REC_FIXED = 2048  # rows of the payload scored before and after each REINIT (the top bucket)
REC_SMALL = 100  # rows of the bisection's poison and companions


def _rec_client(k, jobs, barrier, stop, results) -> None:
    """One client process of the recovery phase (spawned, kept for the
    phase): per job (port, serialized Predicts), one channel, Predicts back
    to back from the barrier until `stop` is set. A Predict refused while
    the replica is quarantined (UNAVAILABLE, `quarantined` in the details)
    is sent again after REC_RETRY_S, as a client with one backend retries.
    Puts the records (send time on time.monotonic, ms to the final answer,
    final status code, refusals) or ("error", text) on `results`; None
    ends it."""
    import traceback

    try:
        import grpc

        from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    except BaseException:  # noqa: BLE001 — the parent fails the phase with it
        results.put(("error", traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            return
        port, reqs = job
        try:
            ch = _channel(port)
            call = ch.unary_unary("/tensorflow.serving.PredictionService/Predict",
                                  response_deserializer=apis.PredictResponse.FromString)
            grpc.channel_ready_future(ch).result(timeout=60)
            barrier.wait(timeout=120)
            recs, i = [], 0
            while not stop.is_set():
                t0 = time.monotonic()
                refused = 0
                while True:
                    try:
                        call(reqs[i % len(reqs)], timeout=60)
                        code = "OK"
                        break
                    except grpc.RpcError as e:
                        code = e.code().name
                        if (code == "UNAVAILABLE" and "quarantined" in (e.details() or "")
                                and refused < 2000):
                            refused += 1
                            time.sleep(REC_RETRY_S)
                            continue
                        break
                recs.append((t0, (time.monotonic() - t0) * 1e3, refused, code))
                i += 1
            ch.close()
            results.put(recs)
        except BaseException:  # noqa: BLE001 — the parent fails the phase with it
            results.put(("error", traceback.format_exc()))


class _HealthPoller:
    """grpc.health.v1 Check of service "" on one channel, as fast as it
    answers, on a thread: (sent, answered (time.monotonic), status,
    x-dts-health-reason)."""

    def __init__(self, port: int):
        import threading

        from distributed_tf_serving_tpu_torch.proto.health import HealthCheckRequest, HealthStub

        self.ch = _channel(port)
        self.stub = HealthStub(self.ch)
        self.req = HealthCheckRequest(service="")
        self.samples: list[tuple] = []
        self.stop_evt = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        import grpc

        while not self.stop_evt.is_set():
            t = time.monotonic()
            try:
                resp, call = self.stub.Check.with_call(self.req, timeout=5)
                reason = dict(call.trailing_metadata() or ()).get("x-dts-health-reason", "")
                self.samples.append((t, time.monotonic(), resp.status, reason))
            except grpc.RpcError as e:
                self.samples.append((t, time.monotonic(), None, e.code().name))
                time.sleep(0.01)

    def close(self) -> list[tuple]:
        self.stop_evt.set()
        self.thread.join(10)
        self.ch.close()
        return self.samples


def _rec_surfaces(http, label: str) -> dict:
    """/recoveryz, /monitoring?section=recovery and the dts_tpu_recovery_*
    series: the same counters and state, the exposition lint-clean."""
    rz = http.json("GET", "/recoveryz")
    sec = http.json("GET", "/monitoring?section=recovery")["recovery"]
    status, data = http.call("GET", "/monitoring/prometheus/metrics")
    if status != 200:
        fail(f"recovery {label}: /monitoring/prometheus/metrics answered {status}")
    lint = subprocess.run([sys.executable, os.path.join(HERE, "tools", "check_prom.py"), "-"],
                          input=data, capture_output=True, timeout=60)
    if lint.returncode != 0:
        fail(f"recovery {label}: tools/check_prom.py rejects the exposition: "
             f"{lint.stdout.decode()[-500:]} {lint.stderr.decode()[-500:]}")
    series = {}
    for line in data.decode().splitlines():
        if line.startswith("dts_tpu_recovery_"):
            key, value = line.rsplit(" ", 1)
            series[key] = float(value)
    c = rz["counters"]
    want = {f'dts_tpu_recovery_state{{state="{rz["state"]}"}}': 1.0,
            **{f"dts_tpu_recovery_{k}_total": float(v) for k, v in c.items()},
            "dts_tpu_recovery_last_cycle_seconds": float(rz["last_cycle"]["duration_s"]),
            "dts_tpu_recovery_mttr_mean_seconds": float(rz["mttr"]["mean_s"])}
    bad = {k: (series.get(k), v) for k, v in want.items() if series.get(k) != v}
    if not rz.get("enabled") or sec["counters"] != c or sec["last_cycle"] != rz["last_cycle"]:
        bad["section"] = {"recoveryz": c, "monitoring": sec["counters"]}
    if bad or len(series) < 17:
        fail(f"recovery {label}: the surfaces disagree: {bad} ({len(series)} series)")
    return {"state": rz["state"], "series": len(series), "counters": c}


def _rec_log(path: str) -> dict:
    """What a recovery CLI server logged: the kernel launches of each
    re-warm, the captured batches' dropped late results and failures, and
    the launch counters at shutdown."""
    import re

    out = {"rewarms": [], "dropped": [], "shutdown": None, "complete": False}
    with open(path) as f:
        for line in f:
            m = re.search(r"recovery re-warm \(round (\d+)\): (\d+) batches in ([\d.]+) s, "
                          r"kernel launches (\{.*\})$", line)
            if m:
                out["rewarms"].append({"round": int(m.group(1)), "batches": int(m.group(2)),
                                       "s": float(m.group(3)),
                                       "launches": json.loads(m.group(4))})
            m = re.search(r"dropped the late (\w+) of a batch of (\d+) requests", line)
            if m:
                out["dropped"].append(m.group(1))
            m = re.search(r"kernel launches at shutdown: (\{.*\})$", line)
            if m:
                out["shutdown"] = json.loads(m.group(1))
            if "shutdown complete" in line:
                out["complete"] = True
    return out


def _recovery_child(out_path: str) -> None:
    """The sticky-error child of the recovery phase (`chip_smoke.py
    --recovery-child OUT`): an in-process stack on configs/latency.toml
    with the plane armed serves a few Predicts; then one fused serve launch
    whose ids address no allocation (2^31 - 1, no range check on the card)
    faults the context for good; Predicts sent after it, the controller's
    verdict and the drain are written to OUT as JSON."""
    import threading

    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.serving import recovery
    from distributed_tf_serving_tpu_torch.serving.server import GrpcHealthService, build_stack
    from distributed_tf_serving_tpu_torch.serving.service import ServiceError
    from distributed_tf_serving_tpu_torch.utils.config import RecoveryConfig, load_config

    out: dict = {}
    cfgs = load_config(os.path.join(HERE, "configs", "latency.toml"))
    rc = RecoveryConfig(enabled=True, watchdog_interval_s=0.1, wedge_quarantine_s=1.0)
    impl, batcher, sv = build_stack(cfgs["server"], cfgs["model"], "cuda", seed=SEED,
                                    batching_config=cfgs["batching"], recovery_config=rc)
    rec = impl.recovery.start()
    taken = []
    take = rec.take_group

    def take_group(group, exc):  # the text each failure brought, as device_fatal read it
        taken.append({"t": time.monotonic(), "text": f"{type(exc).__name__}: {exc}",
                      "fatal": recovery.device_fatal(exc), "requests": len(group)})
        return take(group, exc)

    rec.take_group = take_group
    rng = np.random.RandomState(SEED + 71)
    fields, vocab = cfgs["model"].num_fields, cfgs["model"].vocab_size
    reqs = [_request(rng.randint(0, 1 << 40, size=(REC_N, fields)).astype(np.int64),
                     rng.rand(REC_N, fields).astype(np.float32)) for _ in range(4)]
    out["before"] = [float(_scores_of(impl.predict(r, deadline_s=60))[0]) for r in reqs]
    sw = ck.prepare_serve_weights(sv.params, sv.model.config)
    ids = torch.full((256, fields), 2**31 - 1, dtype=torch.int32, device=batcher.device)
    wts = torch.ones((256, fields), dtype=torch.bfloat16, device=batcher.device)
    t_fault = time.monotonic()
    ck.fused_serve(ids, wts, sw)
    try:
        torch.cuda.synchronize()
        out["sync_error"] = None
    except RuntimeError as exc:
        out["sync_error"] = str(exc)
    out["sync_s"] = time.monotonic() - t_fault
    codes = []

    def one(req):
        try:
            impl.predict(req, deadline_s=60)
            codes.append(("OK", ""))
        except ServiceError as exc:
            codes.append((exc.code, str(exc)[:300]))

    threads = [threading.Thread(target=one, args=(r,)) for r in reqs]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    end = time.monotonic() + 30
    while (rec.snapshot()["last_cycle"] or {}).get("context_lost") is None and \
            time.monotonic() < end:
        time.sleep(0.01)
    out["codes"] = list(codes)
    snap = rec.snapshot()
    out["snapshot"] = {k: snap[k] for k in ("state", "counters", "last_cycle", "events")}
    out["taken"] = taken
    one(reqs[0])  # after the verdict: refused
    out["after_verdict"] = codes[-1]
    health = GrpcHealthService(impl)
    out["health"] = (health._status(""), health._reason(""))
    t0 = time.monotonic()
    rec.shutdown_for_drain(5.0)
    out["drained"] = batcher.drain(5.0)
    batcher.stop()
    out["drain_s"] = time.monotonic() - t0
    out["t_fault"] = t_fault
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)
    if rec.context_lost() is not None:
        # As the CLI server ends once its context is lost (serving/server.py
        # serve): no interpreter teardown, whose frees of pinned buffers
        # torch would abort on.
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)


def phase_recovery(dev, name: str) -> dict:
    """The device-failure recovery plane on the card, out of process. Checks
    in the docstring of the module."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch.models import ServableRegistry
    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto import health as health_proto
    from distributed_tf_serving_tpu_torch.serving import recovery
    from distributed_tf_serving_tpu_torch.serving.batcher import poison_fault_key, prepare_inputs
    from distributed_tf_serving_tpu_torch.serving.server import load_demo_servable
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    import grpc

    out: dict = {"card": name}
    latency = os.path.join(HERE, "configs", "latency.toml")
    cfgs = load_config(latency)
    model_cfg = cfgs["model"]
    grace = cfgs["drain_grace_s"]
    fields = model_cfg.num_fields
    with open(latency) as f:
        toml = f.read() + REC_SECTION
    toml_path = os.path.join(HERE, "chiprun_out", "recovery.toml")
    with open(toml_path, "w") as f:
        f.write(toml)
    rng = np.random.RandomState(SEED + 61)

    def payload(n):
        return {"feat_ids": rng.randint(0, 1 << 40, size=(n, fields)).astype(np.int64),
                "feat_wts": rng.rand(n, fields).astype(np.float32)}

    def key(p):
        return poison_fault_key(prepare_inputs(p))

    fixed = payload(REC_FIXED)
    loads = [[payload(REC_N) for _ in range(3)] for _ in range(REC_CLIENTS)]
    reqs = [[_request(p["feat_ids"], p["feat_wts"]).SerializeToString() for p in mine]
            for mine in loads]
    block, second = payload(REC_N), payload(REC_N)
    poison, comp = payload(REC_SMALL), [payload(REC_SMALL) for _ in range(2)]
    wedged, stalled = payload(REC_N), payload(REC_N)
    env_r = dict(os.environ, DTS_TPU_FAULT_SEED=str(SEED), DTS_TPU_FAULTS=";".join([
        REC_KEYLESS, f"device_lost=error,code=DATA_LOSS,key={key(poison)}",
        f"device_lost=delay,delay={REC_BLOCK_S},key={key(block)}"]))
    env_w = dict(os.environ, DTS_TPU_FAULT_SEED=str(SEED), DTS_TPU_FAULTS=";".join([
        f"batcher.dispatch=wedge,count=1,delay={REC_WEDGE_S}",
        f"device_lost=delay,delay={REC_STALL_S},key={key(stalled)}"]))
    reg = ServableRegistry()
    sv = load_demo_servable(reg, kind="dcn_v2", name="DCN", seed=SEED, config=model_cfg,
                            device=dev)

    def plain(p):
        with torch.inference_mode():
            return sv.model.apply(sv.params, {
                "feat_ids": torch.from_numpy(p["feat_ids"]).to(dev),
                "feat_wts": torch.from_numpy(p["feat_wts"]).to(dev)}
            )["prediction_node"].float().cpu().numpy()

    clients = _FreshClients(REC_CLIENTS, target=_rec_client, label="recovery")
    child_out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_rec_"), "child.json")
    procs: dict = {}
    https: list = []
    launches: dict = {}
    try:
        # Both CLI servers start together (their imports and warmups overlap).
        rest_r, rest_w = _free_port(), _free_port()
        log_r = os.path.join(HERE, "chiprun_out", "recovery_server.log")
        log_w = os.path.join(HERE, "chiprun_out", "recovery_wedge_server.log")
        started = {}

        def start(label, env, rest, log_path):
            started[label] = _start_cli(["--config", toml_path, "--recovery", "--rest-port",
                                         str(rest)], log_path, env=env)

        ths = [threading.Thread(target=start, args=a) for a in
               (("r", env_r, rest_r, log_r), ("w", env_w, rest_w, log_w))]
        for th in ths:
            th.start()
        for th in ths:
            th.join(300)
        if set(started) != {"r", "w"}:
            fail(f"recovery: a CLI server did not start ({sorted(started)})")
        procs = dict(started)
        proc_r, port_r, logf_r = started["r"]
        proc_w, port_w, logf_w = started["w"]
        _wait_port(rest_r, proc_r)
        _wait_port(rest_w, proc_w)
        http_r, http_w = _Http(rest_r), _Http(rest_w)
        https += [http_r, http_w]
        ch_r, ch_w = _channel(port_r), _channel(port_w)
        stub_r, stub_w = PredictionServiceStub(ch_r), PredictionServiceStub(ch_w)

        def predict(stub, p, timeout=60):
            return _scores_of(stub.Predict(_request(p["feat_ids"], p["feat_wts"]),
                                           timeout=timeout))

        def close(a, b):
            return float(np.abs(a - b).max())

        # Server W's first Predict is the wedged one (its wedge rule fires on
        # the first batch): its fixed payload is scored after the REINIT and
        # held to server R's bits from before any fault.
        bits = {"r": [predict(stub_r, fixed)]}
        if close(bits["r"][0], plain(fixed)) > APPLY_TOL:
            fail(f"recovery: the fixed payload's scores {close(bits['r'][0], plain(fixed))} "
                 f"from the plain forward")

        def rz(http):
            return http.json("GET", "/recoveryz")

        def wait_rz(http, pred, what, proc):
            end = time.perf_counter() + REC_WAIT_S
            while True:
                body = rz(http)
                if pred(body):
                    return body
                if proc.poll() is not None:
                    fail(f"recovery: the server exited {proc.returncode} waiting for {what}")
                if time.perf_counter() > end:
                    fail(f"recovery: no {what} within {REC_WAIT_S} s: {body}")
                time.sleep(0.02)

        # 1. The transient kill under the 4-client load.
        poller = _HealthPoller(port_r)
        clients.start(port_r, reqs)
        t_load = time.monotonic()
        z1 = wait_rz(http_r, lambda s: s["counters"]["cycles_completed"] >= 1
                     and s["state"] == "serving", "the keyless rule's cycle", proc_r)
        time.sleep(REC_AFTER_S)
        recs = clients.stop()
        samples = poller.close()
        z1 = rz(http_r)
        ev_q = [e for e in z1["events"] if e["state"] == "quarantined"]
        ev_s = [e for e in z1["events"] if e["state"] == "serving"]
        t_q, t_s = ev_q[0]["t"], ev_s[0]["t"]
        failed = [r for r in recs if r[3] != "OK"]
        refused = sum(r[2] for r in recs)
        during_health = [s for s in samples if t_q <= s[0] and s[1] <= t_s]
        after_health = [s for s in samples if s[0] > t_s]
        bad = []
        if failed:
            bad.append(f"{len(failed)} failed Predicts: {sorted({r[3] for r in failed})}")
        c1 = z1["counters"]
        if not (c1["quarantines"] == 1 and c1["replayed_items"] >= 1
                and c1["poisoned_requests"] == 0 and z1["last_cycle"]["trigger"] == "device_fatal"):
            bad.append(f"counters {c1}, last cycle {z1['last_cycle']}")
        if t_q < t_load:
            bad.append(f"the cycle began {t_load - t_q:.3f} s before the load")
        if any(s[2] != health_proto.SERVING for s in after_health) or not after_health:
            bad.append(f"health after the cycle: {sorted({s[2:] for s in after_health})}")
        if any(s[2] == health_proto.NOT_SERVING and s[3] != "quarantined" for s in samples):
            bad.append("a NOT_SERVING without the quarantined reason")
        if not any(s[2] == health_proto.NOT_SERVING for s in during_health):
            bad.append(f"no NOT_SERVING among the {len(during_health)} checks inside the cycle")
        if bad:
            fail("recovery: the transient cycle: " + "; ".join(bad))
        bits["r"].append(predict(stub_r, fixed))
        # The cycle's split, from its events (ms stamps): the capture
        # (quarantined -> reinit), REINIT with the probe and the re-warm
        # (reinit -> replay), the replay (replay -> serving).
        arc = [e for e in z1["events"] if t_q <= e["t"] <= t_s]
        split = {f"{a['state']}->{b['state']}": round(b["t"] - a["t"], 3)
                 for a, b in zip(arc, arc[1:])}
        lat = {"before": _percentiles([r[1] for r in recs if r[0] < t_q]),
               "during": _percentiles([r[1] for r in recs if t_q <= r[0] <= t_s
                                       or r[0] < t_q <= r[0] + r[1] / 1e3]),
               "after": _percentiles([r[1] for r in recs if r[0] > t_s])}
        out["transient"] = {
            "mttr_s": z1["last_cycle"]["duration_s"], "last_cycle": z1["last_cycle"],
            "split_s": split,
            "counters": c1, "requests": len(recs), "failed": 0, "refused_retried": refused,
            "latency": lat,
            "health_samples": len(samples),
            "health_not_serving_in_cycle": sum(1 for s in during_health
                                               if s[2] == health_proto.NOT_SERVING),
            "health_samples_in_cycle": len(during_health),
        }

        def pp(d):
            return (f"{d.get('p50_ms', float('nan')):.3f} / {d.get('p99_ms', float('nan')):.3f} "
                    f"ms ({d['requests']})")

        log(f"recovery: transient device_lost under {REC_CLIENTS} clients x n = {REC_N}: MTTR "
            f"{z1['last_cycle']['duration_s']:.4f} s ({z1['last_cycle']['rounds']} round, "
            f"{z1['last_cycle']['replayed_items']} replayed; split {split} s), {len(recs)} "
            f"Predicts, 0 failed, "
            f"{refused} refusals retried; p50 / p99 before {pp(lat['before'])}, during "
            f"{pp(lat['during'])}, after {pp(lat['after'])}; health NOT_SERVING (quarantined) in "
            f"{out['transient']['health_not_serving_in_cycle']} of "
            f"{len(during_health)} checks inside the cycle, SERVING in all "
            f"{len(after_health)} after it ({name})")

        # 2. Bisection: the poison coalesced with two clean companions behind
        # a blocker that holds the dispatch stage (its keyed delay) while a
        # second batch waits staged, so the three are queued together.
        c0 = rz(http_r)["counters"]
        res: dict = {}

        def send(label, p, stub=stub_r):
            try:
                res[label] = ("OK", predict(stub, p, timeout=120))
            except grpc.RpcError as e:
                res[label] = (e.code().name, e.details())

        order = [("block", block), ("second", second)]
        ths = []
        for label, p in order:
            ths.append(threading.Thread(target=send, args=(label, p)))
            ths[-1].start()
            time.sleep(0.1)
        for label, p in (("poison", poison), ("c0", comp[0]), ("c1", comp[1])):
            ths.append(threading.Thread(target=send, args=(label, p)))
            ths[-1].start()
        for th in ths:
            th.join(180)
        z2 = wait_rz(http_r, lambda s: s["state"] == "serving" and s["pending_replay_items"] == 0
                     and s["counters"]["poisoned_requests"] >= 1, "the bisection's verdict", proc_r)
        c2 = z2["counters"]
        bad = []
        if res.get("poison", ("",))[0] != "INVALID_ARGUMENT" or "bisection" not in res["poison"][1]:
            bad.append(f"the poison answered {res.get('poison')}")
        errs = {}
        for label, p in (("c0", comp[0]), ("c1", comp[1]), ("block", block), ("second", second)):
            code, got = res.get(label, ("missing", None))
            if code != "OK":
                bad.append(f"{label} answered {code}: {got}")
                continue
            errs[label] = close(got, plain(p))
            if errs[label] > APPLY_TOL:
                bad.append(f"{label} {errs[label]} from the plain forward")
        if not (c2["poisoned_requests"] - c0["poisoned_requests"] == 1
                and c2["bisections"] - c0["bisections"] >= 1):
            bad.append(f"counters {c0} -> {c2}")
        if bad:
            fail("recovery: the bisection: " + "; ".join(bad))
        bits["r"].append(predict(stub_r, fixed))
        out["bisection"] = {"poison": res["poison"][1], "companion_max_abs_err": errs,
                            "counters": c2, "last_cycle": z2["last_cycle"]}
        log(f"recovery: bisection over a coalesced poison + 2 companions: the poison alone "
            f"INVALID_ARGUMENT ({c2['bisections'] - c0['bisections']} bisections, "
            f"{z2['last_cycle']['rounds']} rounds, {z2['last_cycle']['duration_s']:.4f} s), "
            f"companions within {max(errs['c0'], errs['c1']):.2e} of the plain forward")
        out["surfaces"] = _rec_surfaces(http_r, "server")

        # 3. The wedge: a batcher.dispatch wedge held past wedge_quarantine_s.
        t0 = time.monotonic()
        got = predict(stub_w, wedged, timeout=120)
        wedge_ms = (time.monotonic() - t0) * 1e3
        zw = wait_rz(http_w, lambda s: s["counters"]["cycles_completed"] >= 1
                     and s["state"] == "serving", "the wedge's cycle", proc_w)
        time.sleep(max(REC_WEDGE_S - (time.monotonic() - t0), 0) + 0.5)
        lw = _rec_log(log_w)
        cw = zw["counters"]
        bad = []
        if close(got, plain(wedged)) > APPLY_TOL:
            bad.append(f"the wedged Predict {close(got, plain(wedged))} from the plain forward")
        if not (cw["watchdog_wedge_trips"] == 1 and zw["last_cycle"]["trigger"] == "wedge"
                and cw["replayed_items"] == 1):
            bad.append(f"counters {cw}, last cycle {zw['last_cycle']}")
        if lw["dropped"] != ["result"]:
            bad.append(f"the wedged thread's late stage: {lw['dropped']} (want one dropped result)")
        if bad:
            fail("recovery: the wedge: " + "; ".join(bad))
        bits["w"] = [bits["r"][0], predict(stub_w, fixed)]
        out["wedge"] = {"answered_ms": wedge_ms, "counters": cw, "last_cycle": zw["last_cycle"],
                        "dropped": lw["dropped"]}
        log(f"recovery: a batcher.dispatch wedge ({REC_WEDGE_S} s): the watchdog tripped, "
            f"workers replaced, the Predict answered once in {wedge_ms:.1f} ms (MTTR "
            f"{zw['last_cycle']['duration_s']:.4f} s), the wedged thread's late result dropped")

        for label, seq in bits.items():
            if any(b.tobytes() != seq[0].tobytes() for b in seq[1:]):
                fail(f"recovery: the fixed {REC_FIXED}-row payload's bits moved across a REINIT "
                     f"on server {label}")

        # 5. SIGTERM during a cycle, and server R's normal exit.
        poller = _HealthPoller(port_w)
        th = threading.Thread(target=send, args=("stalled", stalled, stub_w))
        th.start()
        zq = wait_rz(http_w, lambda s: s["state"] == "replay", "the stalled payload's replay",
                     proc_w)
        t_cycle = [e for e in zq["events"] if e["state"] == "quarantined"][-1]["t"]
        import signal

        t_term = time.monotonic()
        proc_w.send_signal(signal.SIGTERM)
        try:
            rc_w = proc_w.wait(timeout=grace + 30)
        except subprocess.TimeoutExpired:
            fail(f"recovery: SIGTERM during a cycle: the server did not exit in {grace + 30} s")
        exit_s = time.monotonic() - t_term
        logf_w.close()
        procs.pop("w")
        th.join(60)
        samples = poller.close()
        lw = _rec_log(log_w)
        in_cycle = [s for s in samples if t_cycle <= s[0] and s[1] < t_term]
        bad = []
        if rc_w != 0 or not lw["complete"] or exit_s > grace:
            bad.append(f"exit {rc_w} after {exit_s:.3f} s (grace {grace} s), complete "
                       f"{lw['complete']}")
        if res.get("stalled", ("",))[0] != "OK":
            bad.append(f"the stalled Predict answered {res.get('stalled')}")
        if not in_cycle or any(s[2:] != (health_proto.NOT_SERVING, "quarantined")
                               for s in in_cycle):
            bad.append(f"health inside the cycle: {sorted({s[2:] for s in in_cycle})}")
        if bad:
            fail("recovery: SIGTERM during a cycle: " + "; ".join(bad))
        out["sigterm"] = {"exit_s": exit_s, "grace_s": grace, "state_at_sigterm": zq["state"],
                          "health_in_cycle": len(in_cycle), "dropped": lw["dropped"]}
        log(f"recovery: SIGTERM during a cycle (REPLAY of a payload whose stages stall "
            f"{REC_STALL_S} s): exit 0 in {exit_s:.3f} s (grace {grace} s), the replayed Predict "
            f"answered; health NOT_SERVING (quarantined) in all {len(in_cycle)} checks inside "
            f"the cycle")
        for h in https:
            h.close()
        https = []
        ch_r.close()
        ch_w.close()
        rc_r = _stop_cli(proc_r, logf_r)
        procs.pop("r")
        lr = _rec_log(log_r)
        if rc_r != 0 or not lr["complete"]:
            fail(f"recovery: server R exited {rc_r} (log {log_r})")
        rewarms = lr["rewarms"] + lw["rewarms"]
        if not rewarms or any(r["launches"].get("fused_serve/bfloat16", 0) < 1 for r in rewarms):
            fail(f"recovery: a re-warm launched no fused_serve/bfloat16: {rewarms}")
        for lg in (lr, lw):
            for k, v in (lg["shutdown"] or {}).items():
                launches[k] = launches.get(k, 0) + v
        out["rewarms"] = rewarms
        out["launches"] = launches
        log(f"recovery: {len(rewarms)} re-warms, each launching fused_serve/bfloat16 "
            f"({[r['launches'].get('fused_serve/bfloat16') for r in rewarms]}); "
            f"launches_recovery (both servers, start to exit) {launches}")

        # 4. A real sticky error, in a child process.
        t0 = time.monotonic()
        try:
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--recovery-child",
                                  child_out], cwd=HERE, capture_output=True, text=True,
                                 timeout=REC_CHILD_S)
        except subprocess.TimeoutExpired:
            fail(f"recovery: the sticky-error child did not exit within {REC_CHILD_S} s")
        child_s = time.monotonic() - t0
        with open(os.path.join(HERE, "chiprun_out", "recovery_child.log"), "w") as f:
            f.write(run.stdout + run.stderr)
        if run.returncode != 0 or not os.path.exists(child_out):
            fail(f"recovery: the sticky-error child exited {run.returncode}: "
                 f"{run.stderr[-1500:]}")
        with open(child_out) as f:
            ch = json.load(f)
        snap = ch["snapshot"]
        lost = (snap["last_cycle"] or {}).get("context_lost")
        reinit = [e for e in snap["events"] if e["state"] == "reinit"]
        held = [e for e in snap["events"] if e.get("context_lost")]
        verdict_s = held[0]["t"] - reinit[0]["t"] if held and reinit else None
        fault_to_verdict = held[0]["t"] - ch["t_fault"] if held else None
        bad = []
        if not ch["sync_error"] or not recovery.device_fatal(RuntimeError(ch["sync_error"])):
            bad.append(f"the fault's synchronize raised {ch['sync_error']!r}")
        if not ch["taken"] or not all(t["fatal"] for t in ch["taken"]):
            bad.append(f"device_fatal read {ch['taken']}")
        if lost is None or verdict_s is None or verdict_s > 1.0:
            bad.append(f"the probe's verdict {lost!r} after {verdict_s} s (deadline 1.0 s)")
        if any(c[0] != "UNAVAILABLE" for c in ch["codes"]) or \
                not any("context lost" in c[1] for c in ch["codes"]):
            bad.append(f"the Predicts after the fault answered {ch['codes']}")
        if snap["counters"]["poisoned_requests"] != 0 or snap["state"] != "quarantined":
            bad.append(f"poisoned {snap['counters']['poisoned_requests']}, state {snap['state']}")
        if ch["after_verdict"][0] != "UNAVAILABLE" or \
                ch["health"] != [health_proto.NOT_SERVING, "quarantined"]:
            bad.append(f"after the verdict: {ch['after_verdict']}, health {ch['health']}")
        if not ch["drained"] or ch["drain_s"] > 5.0:
            bad.append(f"the drain: {ch['drained']} in {ch['drain_s']} s")
        if bad:
            fail("recovery: the sticky error: " + "; ".join(bad))
        out["sticky"] = {"sync_error": ch["sync_error"].splitlines()[0],
                         "taken": [t["text"].splitlines()[0] for t in ch["taken"]],
                         "reinit_to_verdict_s": verdict_s, "fault_to_verdict_s": fault_to_verdict,
                         "codes": [c[0] for c in ch["codes"]], "drain_s": ch["drain_s"],
                         "child_s": child_s, "context_lost": lost}
        log(f"recovery: a real sticky error in a child (fused serve ids 2^31 - 1): torch read "
            f"{ch['sync_error'].splitlines()[0]!r}; the batcher's failure "
            f"{ch['taken'][0]['text'].splitlines()[0][:160]!r}; the probe's verdict "
            f"{verdict_s * 1e3:.2f} ms after REINIT began ({fault_to_verdict:.3f} s after the "
            f"fault); {len(ch['codes'])} Predicts UNAVAILABLE, 0 poisoned, held quarantined; "
            f"drain {ch['drain_s']:.3f} s, the child {child_s:.1f} s start to exit ({name})")
    finally:
        for h in https:
            h.close()
        for proc, port, logf in procs.values():
            _stop_cli(proc, logf)
        clients.close()
        torch.cuda.synchronize()
    return out


SM_SIZES = (7, 1000, 2048)  # Predicts of the savedmodel phase
SM_REPEATS = 10  # Predicts per server for the p50 at n = 1000
SM_GRAPH_TOL = 1e-5  # the graph server's scores against the CPU executor's
SM_POLL_S = 0.25  # [server] file_system_poll_wait_seconds of the base-path server


def _keras_name(path: str) -> str:
    """A Keras-style export name for a dcn_v2 param path (the role pass of
    interop/savedmodel.py map_variables binds it without a mapping)."""
    parts = path.split("/")
    leaf = "kernel" if parts[-1] == "w" else "bias"
    if path == "embedding":
        return "model/embedding/embeddings"
    if parts[0] == "cross":
        return f"model/cross_{parts[1]}/{leaf}"
    if parts[0] == "mlp":
        return f"model/{'dense' if parts[1] == '0' else 'dense_' + parts[1]}/{leaf}"
    return f"model/dense_9/{leaf}"


def _write_export(d: str, meta_graph, arrays: dict | None) -> None:
    """A SavedModel directory: saved_model.pb (serve tag), the
    variables/variables.index placeholder the readiness probe reads, and,
    when given, `arrays` as variables_extracted.npz written after them (so
    the npz is the fresher)."""
    import numpy as np

    from distributed_tf_serving_tpu_torch.proto import tf_saved_model_pb2 as smpb

    os.makedirs(os.path.join(d, "variables"))
    proto = smpb.SavedModel(saved_model_schema_version=1)
    mg = proto.meta_graphs.add()
    mg.CopyFrom(meta_graph)
    mg.meta_info_def.tags.append("serve")
    with open(os.path.join(d, "saved_model.pb"), "wb") as f:
        f.write(proto.SerializeToString())
    with open(os.path.join(d, "variables", "variables.index"), "wb") as f:
        f.write(b"")
    if arrays is not None:
        time.sleep(0.02)  # a strictly later mtime than the export's files
        np.savez(os.path.join(d, "variables_extracted.npz"), **arrays)


def _ctr_meta(F: int, outputs=("prediction_node",)):
    """A MetaGraphDef with the CTR serving_default signature (feat_ids
    DT_INT64 [-1, F], feat_wts DT_FLOAT [-1, F])."""
    from distributed_tf_serving_tpu_torch.proto import tf_meta_graph_pb2 as mgpb

    meta = mgpb.MetaGraphDef()
    sd = meta.signature_def["serving_default"]
    sd.method_name = "tensorflow/serving/predict"
    for alias, dt in (("feat_ids", 9), ("feat_wts", 1)):
        sd.inputs[alias].name = f"{alias}:0"
        sd.inputs[alias].dtype = dt
        sd.inputs[alias].tensor_shape.dim.add(size=-1)
        sd.inputs[alias].tensor_shape.dim.add(size=F)
    for alias in outputs:
        sd.outputs[alias].name = f"{alias}:0"
        sd.outputs[alias].dtype = 9 if alias == "id_sum" else 1
        sd.outputs[alias].tensor_shape.dim.add(size=-1)
    return meta


def _graph_export_meta(F: int, D: int, vocab: int, dims: tuple[int, ...]):
    """The graph export's MetaGraphDef: FloorMod -> embedding gather ->
    weight -> Shape / StridedSlice / Pack / Reshape -> MLP -> Sigmoid, and
    the ids' row sums (`id_sum`)."""
    from distributed_tf_serving_tpu_torch import codec

    import numpy as np

    meta = _ctr_meta(F, outputs=("prediction_node", "id_sum"))
    g = meta.graph_def

    def node(name, op, *inputs, **attrs):
        n = g.node.add(name=name, op=op)
        n.input.extend(inputs)
        for k, v in attrs.items():
            if isinstance(v, bytes):
                n.attr[k].s = v
            elif isinstance(v, list):
                n.attr[k].list.i.extend(v)
            else:
                n.attr[k].i = v
        return n

    def const(name, value):
        n = node(name, "Const")
        n.attr["value"].tensor.CopyFrom(codec.from_ndarray(np.asarray(value)))
        n.attr["dtype"].type = n.attr["value"].tensor.dtype

    def variable(name):
        node(name, "VarHandleOp", shared_name=name.encode())
        node(f"{name}/read", "ReadVariableOp", name)
        return f"{name}/read"

    node("feat_ids", "Placeholder")
    node("feat_wts", "Placeholder")
    const("vocab", np.int64(vocab))
    node("rows", "FloorMod", "feat_ids", "vocab")
    const("axis0", np.int32(0))
    node("emb", "GatherV2", variable("embedding"), "rows", "axis0")
    const("last", np.int32(-1))
    node("wts3", "ExpandDims", "feat_wts", "last")
    node("weighted", "Mul", "emb", "wts3")
    node("shape", "Shape", "weighted")
    const("zero1", np.array([0], np.int32))
    const("one1", np.array([1], np.int32))
    node("n", "StridedSlice", "shape", "zero1", "one1", "one1", shrink_axis_mask=1)
    const("width", np.int32(F * D))
    node("flat_shape", "Pack", "n", "width")
    x = node("x", "Reshape", "weighted", "flat_shape").name
    for i, _ in enumerate(dims):
        node(f"mm{i}", "MatMul", x, variable(f"w{i}"))
        node(f"ba{i}", "BiasAdd", f"mm{i}", variable(f"b{i}"))
        x = node(f"relu{i}", "Relu", f"ba{i}").name
    node("mm_out", "MatMul", x, variable("w_out"))
    node("logit2", "BiasAdd", "mm_out", variable("b_out"))
    node("logit", "Squeeze", "logit2", squeeze_dims=[1])
    node("prediction_node", "Sigmoid", "logit")
    node("id_sum", "Sum", "feat_ids", "one1")
    return meta


def _graph_variables(F: int, D: int, vocab: int, dims: tuple[int, ...], seed: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {"embedding": rng.standard_normal((vocab, D), dtype=np.float32) * np.float32(0.5)}
    width = F * D
    for i, d in enumerate(dims):
        out[f"w{i}"] = (rng.standard_normal((width, d), dtype=np.float32)
                        * np.float32(np.sqrt(2.0 / width)))
        out[f"b{i}"] = rng.standard_normal(d, dtype=np.float32) * np.float32(0.01)
        width = d
    out["w_out"] = rng.standard_normal((width, 1), dtype=np.float32) * np.float32(
        np.sqrt(1.0 / width))
    out["b_out"] = np.zeros(1, np.float32)
    return out


def _log_json(path: str, pattern: str) -> dict | None:
    import re

    with open(path) as f:
        m = re.search(pattern + r"(\{.*\})$", f.read(), re.M)
    return json.loads(m.group(1)) if m else None


def phase_savedmodel(dev, name: str) -> dict:
    """The SavedModel intake on the card, through the CLI servers. Checks in
    the docstring of the module."""
    import re
    import shutil
    import tempfile
    import threading

    import grpc
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map

    from distributed_tf_serving_tpu_torch import codec
    from distributed_tf_serving_tpu_torch.interop import savedmodel as sm
    from distributed_tf_serving_tpu_torch.interop.graph_exec import graph_model
    from distributed_tf_serving_tpu_torch.models import build_model
    from distributed_tf_serving_tpu_torch.proto import ModelServiceStub, PredictionServiceStub
    from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis
    from distributed_tf_serving_tpu_torch.proto.service_grpc import LARGE_MESSAGE_CHANNEL_OPTIONS
    from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    out_dir = os.path.join(HERE, "chiprun_out")
    latency = os.path.join(HERE, "configs", "latency.toml")
    with open(latency) as f:
        text = f.read()
    text, k = re.subn(r"(?m)^\[server\]\n",
                      f"[server]\nfile_system_poll_wait_seconds = {SM_POLL_S}\n", text)
    if k != 1:
        fail("configs/latency.toml has no [server] section")
    polled = os.path.join(out_dir, "savedmodel_base.toml")
    with open(polled, "w") as f:
        f.write(text)
    mc = load_config(latency)["model"]
    F, D, V = mc.num_fields, mc.embed_dim, mc.vocab_size
    model = build_model("dcn_v2", mc)
    plain = build_model("dcn_v2", dataclasses.replace(model.config, use_pallas_cross=False))
    params = {seed: model.init(seed, "cpu") for seed in (0, 1)}

    def keras_arrays(tree) -> dict:
        return {_keras_name(p): t.numpy() for p, t in sm._flatten_params(tree).items()}

    root = tempfile.mkdtemp(prefix="dts_savedmodel_")
    graph_dir = os.path.join(root, "graph")
    res: dict = {"card": name}
    procs: list = []
    try:
        zoo, ckpt = os.path.join(root, "zoo"), os.path.join(root, "ckpt")
        base = os.path.join(root, "base")
        _write_export(zoo, _ctr_meta(F), keras_arrays(params[0]))
        _write_export(os.path.join(base, "1"), _ctr_meta(F), keras_arrays(params[0]))
        dims = tuple(mc.mlp_dims)
        gmeta = _graph_export_meta(F, D, V, dims)
        gvars = _graph_variables(F, D, V, dims, SEED + 3000)
        # The card's machine has no TensorFlow to extract the graph's
        # variables: they go where the importer's extraction would put them.
        _write_export(graph_dir, gmeta, None)
        time.sleep(0.02)
        np.savez(sm.graph_cache_path(graph_dir), **gvars)
        res["write_s"] = time.perf_counter() - t_phase

        # Every server and the conversion start at once; the checkpoint
        # server starts when the conversion is done, and comes up while the
        # base-path and graph checks run.
        t0 = time.perf_counter()
        convert = subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.interop.savedmodel", zoo, ckpt],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        spawned = {
            "import": (["--config", latency, "--savedmodel", zoo], "savedmodel_import.log"),
            "base": (["--config", polled, "--model-base-path", base], "savedmodel_base.log"),
            "graph": (["--config", latency, "--model-kind", "graph", "--savedmodel",
                       graph_dir], "savedmodel_graph.log"),
        }
        handles = {}
        for key, (args, logname) in spawned.items():
            handles[key] = _spawn_cli(args, os.path.join(out_dir, logname))
            procs.append(handles[key])
        for key, (proc, port, logf) in handles.items():
            _await_cli(proc, port, logf, [key], os.path.join(out_dir, f"savedmodel_{key}.log"))
        res["servers_ready_s"] = time.perf_counter() - t0
        conv_out, _ = convert.communicate(timeout=LIFECYCLE_WAIT_S)
        if convert.returncode != 0:
            fail(f"savedmodel: the conversion CLI exited {convert.returncode}: "
                 f"{conv_out[-2000:]}")
        res["convert_s"] = time.perf_counter() - t0
        handles["ckpt"] = _spawn_cli(["--config", latency, "--checkpoint", ckpt],
                                     os.path.join(out_dir, "savedmodel_ckpt.log"))
        procs.append(handles["ckpt"])
        chans = {key: grpc.insecure_channel(f"127.0.0.1:{h[1]}",
                                            options=LARGE_MESSAGE_CHANNEL_OPTIONS)
                 for key, h in handles.items()}
        stubs = {key: PredictionServiceStub(ch) for key, ch in chans.items()}
        rng = np.random.RandomState(SEED + 3100)
        # The reference's weights reach the card by a plain copy, apart
        # from the importer under test.
        on_card = {seed: tree_map(lambda t: t.to(dev), tree) for seed, tree in params.items()}

        def plain_scores(seed, ids, wts):
            with torch.inference_mode():
                return plain.apply(on_card[seed], {
                    "feat_ids": torch.from_numpy(fold_ids_host(ids, V)).to(dev),
                    "feat_wts": torch.from_numpy(wts).to(dev)})[
                    "prediction_node"].float().cpu().numpy()

        # ---- SavedModel versions under --model-base-path
        stop = threading.Event()
        lock = threading.Lock()
        seen: list = []  # (perf_counter, version)
        failures: list = []
        errs: dict = {}
        loads = [(rng.randint(0, 1 << 40, size=(1000, F)).astype(np.int64),
                  rng.rand(1000, F).astype(np.float32)) for _ in range(2)]
        want = {(v, i): plain_scores(v - 1, *loads[i]) for v in (1, 2) for i in range(2)}

        def client(i: int) -> None:
            stub = PredictionServiceStub(chans["base"])
            req = _request(*loads[i])
            while not stop.is_set():
                try:
                    resp = stub.Predict(req, timeout=60)
                except Exception as e:  # noqa: BLE001 — every failure counts
                    failures.append(repr(e))
                    continue
                v = resp.model_spec.version.value
                err = float(np.max(np.abs(codec.to_ndarray(resp.outputs["prediction_node"])
                                          - want[v, i])))
                with lock:
                    seen.append((time.perf_counter(), v))
                    errs[v] = max(errs.get(v, 0.0), err)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        time.sleep(1.0)
        staged = os.path.join(root, "stage2")
        _write_export(staged, _ctr_meta(F), keras_arrays(params[1]))
        t_pub = time.perf_counter()
        os.rename(staged, os.path.join(base, "2"))
        end = t_pub + LIFECYCLE_WAIT_S
        while not any(v == 2 for _, v in list(seen)):
            if time.perf_counter() > end or handles["base"][0].poll() is not None:
                stop.set()
                fail(f"savedmodel: v2 was not served within {LIFECYCLE_WAIT_S} s "
                     f"(log {out_dir}/savedmodel_base.log)")
            time.sleep(0.02)
        first_v2 = min(t for t, v in seen if v == 2)
        time.sleep(1.0)
        stop.set()
        for th in threads:
            th.join(timeout=60)
        status = ModelServiceStub(chans["base"]).GetModelStatus(
            apis.GetModelStatusRequest(model_spec=apis.ModelSpec(name="DCN")), timeout=10)
        versions = sorted(s.version for s in status.model_version_status)
        res["swap"] = {"publish_to_first_v2_s": first_v2 - t_pub, "failed": len(failures),
                       "responses": len(seen),
                       "by_version": {v: sum(1 for _, x in seen if x == v) for v in (1, 2)},
                       "max_abs_err": errs, "versions": versions,
                       "load": _log_json(os.path.join(out_dir, "savedmodel_base.log"),
                                         r"loaded DCN v2 from \S+: ")}
        if failures:
            fail(f"savedmodel: {len(failures)} Predicts failed across the swap: {failures[:3]}")
        if versions != [1, 2] or not all(e <= APPLY_TOL for e in errs.values()):
            fail(f"savedmodel: swap ended at versions {versions}, errors {errs}")

        # ---- the graph executor
        cpu_model, cpu_params = graph_model(gmeta, gvars, device="cpu")
        res["graph"] = {"max_abs_err": {}}
        for n in SM_SIZES:
            ids = rng.randint(1 << 31, 1 << 40, size=(n, F)).astype(np.int64)
            wts = rng.rand(n, F).astype(np.float32)
            greq = apis.PredictRequest()
            greq.model_spec.name = "DCN"
            codec.from_ndarray(ids, out=greq.inputs["feat_ids"])
            codec.from_ndarray(wts, out=greq.inputs["feat_wts"])
            resp = stubs["graph"].Predict(greq, timeout=120)
            id_sum = codec.to_ndarray(resp.outputs["id_sum"])
            if id_sum.dtype != np.int64 or not np.array_equal(id_sum, ids.sum(axis=1)):
                fail(f"savedmodel: the graph server's int64 ids did not arrive intact (n = {n})")
            want_g = cpu_model.apply(cpu_params, {"feat_ids": torch.from_numpy(ids),
                                                  "feat_wts": torch.from_numpy(wts)})
            err = float(np.max(np.abs(codec.to_ndarray(resp.outputs["prediction_node"])
                                      - want_g["prediction_node"].numpy())))
            res["graph"]["max_abs_err"][n] = err
            if not err <= SM_GRAPH_TOL:
                fail(f"savedmodel: graph server n = {n} scores {err} from the CPU executor")

        # ---- the zoo-bound import against its conversion
        _await_cli(*handles["ckpt"], ["ckpt"], os.path.join(out_dir, "savedmodel_ckpt.log"))
        res["ckpt_ready_s"] = time.perf_counter() - t0
        payloads = {n: (rng.randint(0, 1 << 40, size=(n, F)).astype(np.int64),
                        rng.rand(n, F).astype(np.float32)) for n in SM_SIZES}
        scores = {}
        for key in ("import", "ckpt"):
            for n, (ids, wts) in payloads.items():
                t1 = time.perf_counter()
                resp = stubs[key].Predict(_request(ids, wts), timeout=120)
                ms = (time.perf_counter() - t1) * 1e3
                if (key, n) == ("import", SM_SIZES[0]):
                    res["first_predict_ms"] = ms
                scores[key, n] = codec.to_ndarray(resp.outputs["prediction_node"])
        res["max_abs_err"] = {}
        for n, (ids, wts) in payloads.items():
            want = plain_scores(0, ids, wts)
            err = max(float(np.max(np.abs(scores[k, n] - want))) for k in ("import", "ckpt"))
            res["max_abs_err"][n] = err
            if not err <= APPLY_TOL:
                fail(f"savedmodel: n = {n} scores {err} from the plain forward (> {APPLY_TOL})")
        top = SM_SIZES[-1]
        if not np.array_equal(scores["import", top], scores["ckpt", top]):
            fail(f"savedmodel: the import server's n = {top} scores are not the bits of the "
                 "checkpoint server's")
        res["p50_1000_ms"] = {}
        req = _request(*payloads[1000])
        for key in ("import", "ckpt"):
            lat = []
            for _ in range(SM_REPEATS):
                t1 = time.perf_counter()
                stubs[key].Predict(req, timeout=120)
                lat.append((time.perf_counter() - t1) * 1e3)
            res["p50_1000_ms"][key] = statistics.median(lat)

        for key in ("import", "ckpt", "base", "graph"):
            chans[key].close()
        # The graph export's warm calls on the card, in a process of its own:
        # after the earlier phases this process's profiler loses kernel
        # events, and the servers are idle by now.
        calls = os.path.join(out_dir, "savedmodel_graph_calls.json")
        child = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                                "--graph-calls", graph_dir, calls],
                               cwd=HERE, capture_output=True, text=True,
                               timeout=LIFECYCLE_WAIT_S)
        if child.returncode != 0:
            fail(f"savedmodel: the graph-calls child exited {child.returncode}: "
                 f"{child.stderr[-2000:]}")
        with open(calls) as f:
            res["graph"]["calls"] = {int(n): c for n, c in json.load(f).items()}
    finally:
        for proc, _port, logf in procs:
            _stop_cli(proc, logf)
        # The graph export's variables, seeded into the importer's cache
        # outside `root`.
        if os.path.exists(sm.graph_cache_path(graph_dir)):
            os.unlink(sm.graph_cache_path(graph_dir))
        shutil.rmtree(root, ignore_errors=True)

    def diff(end: dict | None, start: dict | None) -> dict:
        end, start = end or {}, start or {}
        return {k: end.get(k, 0) - start.get(k, 0) for k in set(start) | set(end)}

    key = "fused_serve/bfloat16"
    log_path = os.path.join(out_dir, "savedmodel_import.log")
    # The import server over its Predicts: its count at shutdown less its
    # count when it was ready.
    res["launches"] = diff(_log_json(log_path, r"kernel launches at shutdown: "),
                           _log_json(log_path, r"kernel launches at start: "))
    if not res["launches"].get(key, 0) > 0:
        fail(f"savedmodel: the import server's Predicts launched no {key} ({res['launches']})")
    # The base-path server over the swap: its count at shutdown less its
    # count at v1's load (v1's Predicts, v2's warmup and Predicts), and
    # less its count at v2's load (v2's Predicts alone).
    base = _server_log(os.path.join(out_dir, "savedmodel_base.log"))
    if len(base["changes"]) < 2 or base["shutdown"] is None:
        fail(f"savedmodel: the base-path server logged {len(base['changes'])} version "
             f"changes and {'a' if base['shutdown'] else 'no'} shutdown count")
    res["launches_base"] = diff(base["shutdown"], base["changes"][0])
    res["launches_base_v2"] = diff(base["shutdown"], base["changes"][-1])
    if not res["launches_base_v2"].get(key, 0) > 0:
        fail(f"savedmodel: the imported v2's Predicts launched no {key} "
             f"({res['launches_base_v2']})")
    res["import_s"] = _log_json(log_path, r"imported SavedModel \S+: DCN v1 ")
    if res["import_s"] is None:
        fail("savedmodel: the import server logged no import timings")
    res["phase_s"] = time.perf_counter() - t_phase
    imp = res["import_s"]
    log(f"savedmodel: import {imp['parse_s'] * 1e3:.1f} ms pb parse, "
        f"{imp['npz_s'] * 1e3:.1f} ms npz load, {imp['map_s'] * 1e3:.1f} ms map, "
        f"{imp['ctx_s'] * 1e3:.1f} ms CUDA context, "
        f"{imp['h2d_s'] * 1e3:.1f} ms H2D; first Predict (n = {SM_SIZES[0]}) "
        f"{res['first_predict_ms']:.2f} ms; p50 n = 1000 import "
        f"{res['p50_1000_ms']['import']:.3f} ms vs checkpoint {res['p50_1000_ms']['ckpt']:.3f} ms"
        f"; max |err| {res['max_abs_err']}; fused_serve launches over the Predicts "
        f"{res['launches']} ({name})")
    log(f"savedmodel: swap publish -> first v2 response {res['swap']['publish_to_first_v2_s']:.3f}"
        f" s, {res['swap']['responses']} responses {res['swap']['by_version']}, 0 failed, "
        f"v2 load {res['swap']['load']}; base-path launches from v1's load "
        f"{res['launches_base']}, over v2's Predicts {res['launches_base_v2']} ({name})")
    for n, c in res["graph"]["calls"].items():
        log(f"savedmodel: graph executor n = {n}: p50 {c['p50_ms']:.3f} ms, "
            f"{c['launches_per_call']:.1f} launches per call; server max |err| "
            f"{res['graph']['max_abs_err']} ({name})")
    log(f"savedmodel: phase {res['phase_s']:.1f} s (servers ready {res['servers_ready_s']:.1f} s, "
        f"conversion {res['convert_s']:.1f} s, checkpoint server {res['ckpt_ready_s']:.1f} s)")
    return res


def _graph_calls_child(graph_dir: str, out_path: str) -> None:
    """`chip_smoke.py --graph-calls DIR OUT`: the savedmodel phase's graph
    export imported on the card (its variables already in the graph cache)
    and timed at n = 1000 and 2048: one warm model.apply under
    torch.cuda.set_sync_debug_mode("error") (a synchronizing op fails it),
    then its p50 (`call_ms`) and its launches per call (`kernels_per_call`),
    which must be above 0, written to OUT as JSON."""
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch.interop import savedmodel as sm
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    dev = torch.device("cuda", 0)
    mc = load_config(os.path.join(HERE, "configs", "latency.toml"))["model"]
    sv = sm.import_savedmodel(graph_dir, "graph", mc, device=dev)
    rng = np.random.RandomState(SEED + 3200)
    out = {}
    for n in (1000, 2048):
        batch = {"feat_ids": torch.from_numpy(
            rng.randint(0, 1 << 40, size=(n, mc.num_fields)).astype(np.int64)).to(dev),
            "feat_wts": torch.from_numpy(
                rng.rand(n, mc.num_fields).astype(np.float32)).to(dev)}

        def call(batch=batch):
            with torch.inference_mode():
                return sv.model.apply(sv.params, batch)

        call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        except RuntimeError as e:
            fail(f"savedmodel: a warm graph call synchronized with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[n] = {"p50_ms": call_ms(call), "launches_per_call": kernels_per_call(call)}
        if not out[n]["launches_per_call"] > 0:
            fail(f"savedmodel: the profiler saw no launch of the graph executor at n = {n}")
    with open(out_path, "w") as f:
        json.dump(out, f)


FLEET_REPLICAS = 3
FLEET_GOSSIP_S = 0.25  # [fleet] gossip_interval_s of every member
FLEET_TTL_S = 1.5  # [fleet] record_ttl_s: a SIGKILLed member fades after this
FLEET_POLL_S = 0.25  # [server] file_system_poll_wait_seconds of the replicas
FLEET_N = 1000  # candidates per Predict ([client] candidate_num of latency.toml)
FLEET_EDGE = (2, 2)  # edge client processes, concurrent Predicts each ([client] concurrent_num 4)
# Each edge worker's pause between Predicts (the JAX package's fleet soak
# pauses 20 ms). At 100 ms the four loops offer a small share of what the
# router carries unpaced (PERF.md §6 gives both rates on the H100): the
# failover gate then measures a fleet with headroom, not the router (a
# Python process, the tier that saturates first; its CPU is read below)
# nor the restarted replica's start-up on the same host cores. The
# environment's FLEET_EDGE_PAUSE_S overrides it, for runs at other paces.
FLEET_EDGE_PAUSE_S = float(os.environ.get("FLEET_EDGE_PAUSE_S", "0.1"))
FLEET_AUDIT_FRACTION = 0.05  # the router's [integrity] router_audit_fraction
FLEET_PROBES = 30  # sequential Predicts per path for the p50 / p99 lines
FLEET_STEADY_S = 5.0  # edge traffic before the kill
FLEET_DOWN_S = 2.0  # the victim stays dead this long before its restart
FLEET_AFTER_S = 2.0  # edge traffic kept up after the fleet-wide rollback
FLEET_WAIT_S = 120.0  # bound on each wait of the phase
FLEET_TOL = APPLY_TOL  # direct sharded scores against the plain forward
# tools/check_fleet_smoke.py's bounds.
MIN_GOODPUT_RATIO = 0.5
REJOIN_BOUND_S = 45.0
PROPAGATION_SLACK_S = 1.0
# tools/check_fleetobs_smoke.py's tolerances.
WATERFALL_CLOSE_TOL = 0.02
QPS_AGG_TOL = 0.05
FLEET_REPLICA_TOML = ("\n[quality]\nreference_file = \"\"\n"
                      "\n[lifecycle]\nenabled = true\ntick_interval_s = 0.2\n"
                      "canary_probe_only_s = 0.5\ncanary_initial_fraction = 0.25\n"
                      "canary_ramp_step = 0.05\ncanary_step_dwell_s = 30.0\n"
                      "canary_max_fraction = 0.3\npromote_after_s = 3600.0\n"
                      "min_canary_scores = 1000000000\nrollback_psi = 1000.0\n"
                      "rollback_hold_s = 60.0\n"
                      "\n[observability]\ntracing = true\ntrace_sample_rate = 1.0\n"
                      "trace_export = true\n")
FLEET_ROUTER_TOML = ("\n[observability]\ntracing = true\ntrace_sample_rate = 1.0\n"
                     "trace_export = true\ntrace_export_interval_s = 0.5\n"
                     "\n[slo]\nenabled = true\nlatency_target_ms = 100.0\nshort_window_s = 2.0\n"
                     "long_window_s = 8.0\n"
                     "\n[integrity]\nenabled = true\n"
                     f"router_audit_fraction = {FLEET_AUDIT_FRACTION}\n")


def _fleet_edge(k, router, n, fields, workers, pause_s, ingest_port, ready, start, stop,
                results) -> None:
    """One edge client process of the fleet phase (spawned): the port's
    ShardedPredictClient with hosts = [the router], traced (sample rate
    1), `workers` concurrent loops of pre-built n-candidate Predicts, each
    followed by a `pause_s` pause, from `start` until `stop`. Puts its records (send and answer times on
    time.time(), the error or "") on `results`, then pushes its kept span
    trees to the router's /tracez/ingest, the first hop of every stitched
    trace; ("error", text) on a failure."""
    import asyncio
    import http.client
    import traceback

    try:
        from distributed_tf_serving_tpu_torch.client import ShardedPredictClient, make_payload
        from distributed_tf_serving_tpu_torch.utils import tracing

        tracing.enable(buffer_size=512, sample_rate=1.0)

        async def run():
            async with ShardedPredictClient([router], "DCN", timeout_s=30.0, failover_attempts=1,
                                            backoff_initial_s=0.02) as client:
                preps = [client.prepare(make_payload(n, fields, seed=7000 + 10 * k + s))
                         for s in range(3)]
                await client.predict_prepared(preps[0])  # the channel connects here
                ready.put(k)
                while not start.is_set():
                    await asyncio.sleep(0.005)
                recs = []

                async def worker(w):
                    i = 0
                    while not stop.is_set():
                        t0 = time.time()
                        try:
                            await client.predict_prepared(preps[(w + i) % len(preps)])
                            recs.append((t0, time.time(), ""))
                        except Exception as e:  # noqa: BLE001 — every failure is counted
                            recs.append((t0, time.time(), repr(e)[:200]))
                        i += 1
                        await asyncio.sleep(pause_s)

                await asyncio.gather(*(worker(w) for w in range(workers)))
                return recs

        recs = asyncio.run(run())
        results.put(recs)
        cursor, pushed = 0, 0
        while True:
            export = tracing.recorder().export_since(cursor)
            if not export.get("spans"):
                break
            conn = http.client.HTTPConnection("127.0.0.1", ingest_port, timeout=30)
            conn.request("POST", "/tracez/ingest",
                         body=json.dumps({"source": f"edge{k}", **export}).encode(),
                         headers={"Content-Type": "application/json"})
            body = json.loads(conn.getresponse().read())
            conn.close()
            pushed += int(body.get("accepted") or 0)
            cursor = int(export.get("cursor") or cursor)
        results.put(("pushed", pushed))
    except BaseException:  # noqa: BLE001 — the parent fails the phase with it
        results.put(("error", traceback.format_exc()))


def _cpu_seconds(pid: int) -> float:
    """User + system CPU seconds a process has used (/proc/PID/stat)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _get_json(port: int, path: str, body: dict | None = None, timeout: float = 10.0):
    """(status, JSON) of one request to 127.0.0.1:port (a gossip or REST
    port)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if body is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
        return r.status, (json.loads(data) if data[:1] in (b"{", b"[") else data.decode())
    finally:
        conn.close()


def _poll(fn, what: str, timeout: float = FLEET_WAIT_S, every: float = 0.05,
          phase: str = "fleet"):
    """fn()'s first truthy value and the seconds it took; the run fails
    after `timeout`. An exception in fn counts as not yet."""
    t0 = time.perf_counter()
    while True:
        try:
            v = fn()
        except Exception:  # noqa: BLE001 — surfaces settle asynchronously
            v = None
        if v:
            return v, time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            fail(f"{phase}: no {what} within {timeout} s")
        time.sleep(every)


def _windows(ok_times: list, t0: float, t1: float) -> list:
    """Answers per 1 s window of [t0, t1)."""
    import bisect

    out, w = [], t0
    while w + 1.0 <= t1:
        out.append(bisect.bisect_left(ok_times, w + 1.0) - bisect.bisect_left(ok_times, w))
        w += 1.0
    return out


def _served_launches(path: str) -> dict:
    """A base-path CLI server's kernel launches outside its versions'
    warmups, from its log: each count from a version change (the version
    warmed and serving) to the next version's "before warming" line or to
    the count at shutdown, summed. A warmup window's launches, a version's
    own and whatever was served beside them, are left out."""
    import re

    served, since = {}, None
    with open(path) as f:
        for line in f:
            m = re.search(r"kernel launches (before warming \S+ v\d+|after a \S+ version "
                          r"change|at shutdown): (\{.*\})$", line)
            if not m:
                continue
            now = json.loads(m.group(2))
            if since is not None and not m.group(1).startswith("after"):
                for k in set(now) | set(since):
                    served[k] = served.get(k, 0) + now.get(k, 0) - since.get(k, 0)
                since = None
            elif since is None and m.group(1).startswith("after"):
                since = now
    return served


def _prom_lint(text: str, what: str) -> None:
    lint = subprocess.run([sys.executable, os.path.join(HERE, "tools", "check_prom.py"), "-"],
                          input=text.encode(), capture_output=True, timeout=60)
    if lint.returncode != 0:
        fail(f"{what} fails tools/check_prom.py: {lint.stdout[-400:]!r} "
             f"{lint.stderr[-400:]!r}")


def phase_fleet(dev, name: str) -> dict:
    """The fleet tier on the card: v1 (seed 0) written with save_servable at
    the full width of configs/latency.toml into a shared base path; three
    replica CLI processes (--fleet, [lifecycle], trace export, REST) and one
    `--router` process (the router's [client] hosts the three replicas,
    rollout_writer, [slo] on, its audit armed); edge clients in spawned
    processes (the port's ShardedPredictClient, hosts = [router], n =
    1000) and a direct sharded
    client over the three replicas (the reference's own fan-out). Checks:
    the direct scores within 5e-3 of the plain forward and the router's
    the bits of the direct ones (the same rows to the same replica); a
    replica SIGKILLed mid-traffic with 0 edge errors and every 1 s goodput
    window until the canary publish at least MIN_GOODPUT_RATIO of the
    steady median; its restart rejoining through gossip within
    REJOIN_BOUND_S; until the canary publish, the router's audits of the
    edge's requests more than 0 and none a mismatch; v2 (seed 1)
    published, live on every replica, rolled back through one replica's
    POST /lifecyclez/rollback, blacklisted by the router and rolled back everywhere within one gossip interval plus
    PROPAGATION_SLACK_S, with 0 failed Predicts, and the scores checked
    again after; a stitched trace of at least 3 processes on the router's
    /tracez whose waterfall closes within 2 %, /fleet/monitoring's qps
    within 5 % of its members' sum, finite /sloz burn rates, and
    dts_tpu_fleet_* series on the router's /metrics and a replica's
    exposition passing tools/check_prom.py; every replica's served
    fused_serve/bfloat16 launches (_served_launches) above 0 and its
    device cuda."""
    import asyncio
    import multiprocessing
    import re
    import shutil
    import signal
    import tempfile

    import grpc
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch.client import ShardedPredictClient, make_payload
    from distributed_tf_serving_tpu_torch.models import Servable, build_model, ctr_signatures
    from distributed_tf_serving_tpu_torch.proto import health as health_proto
    from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host
    from distributed_tf_serving_tpu_torch.train.checkpoint import save_servable
    from distributed_tf_serving_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(HERE, "configs", "latency.toml")) as f:
        base_text = f.read()
    base_text, k = re.subn(r"(?m)^\[server\]\n",
                           f"[server]\nfile_system_poll_wait_seconds = {FLEET_POLL_S}\n",
                           base_text)
    if k != 1:
        fail("configs/latency.toml has no [server] section")
    tmp = tempfile.mkdtemp(prefix="dts_fleet_")
    probe_cfg = os.path.join(tmp, "probe.toml")
    with open(probe_cfg, "w") as f:
        f.write(base_text)
    mc = load_config(probe_cfg)["model"]
    F = mc.num_fields
    model = build_model("dcn_v2", mc)
    plain = build_model("dcn_v2", dataclasses.replace(model.config, use_pallas_cross=False))
    probe = make_payload(FLEET_N, F, seed=SEED + 3000)
    params = {v: model.init(v - 1, "cpu") for v in (1, 2)}
    on_card = {
        "embedding": params[1]["embedding"].to(dev),
        "cross": [{k: t.to(dev) for k, t in p.items()} for p in params[1]["cross"]],
        "mlp": [{k: t.to(dev) for k, t in p.items()} for p in params[1]["mlp"]],
        "out": {k: t.to(dev) for k, t in params[1]["out"].items()},
    }
    with torch.inference_mode():
        want = plain.apply(on_card, {
            "feat_ids": torch.from_numpy(fold_ids_host(probe["feat_ids"], mc.vocab_size)).to(dev),
            "feat_wts": torch.from_numpy(probe["feat_wts"]).to(dev),
        })["prediction_node"].float().cpu().numpy()
    del on_card
    torch.cuda.empty_cache()

    base = os.path.join(tmp, "models")
    os.makedirs(base)
    save_servable(os.path.join(base, "1"), Servable(
        name="DCN", version=1, model=model, params=params[1], signatures=ctr_signatures(F)),
        "dcn_v2")

    ports = [_free_port() for _ in range(FLEET_REPLICAS)]
    rest_ports = [_free_port() for _ in range(FLEET_REPLICAS)]
    gossip_ports = [_free_port() for _ in range(FLEET_REPLICAS)]
    router_port, router_gossip = _free_port(), _free_port()
    hosts = [f"127.0.0.1:{p}" for p in ports]
    router = f"127.0.0.1:{router_port}"
    # A star: every replica gossips with the router; push-pull through the
    # common peer converges the whole membership.
    for i in range(FLEET_REPLICAS):
        with open(os.path.join(tmp, f"replica{i}.toml"), "w") as f:
            f.write(base_text + FLEET_REPLICA_TOML
                    + f"\n[fleet]\nenabled = true\nself_id = \"{hosts[i]}\"\n"
                    f"gossip_port = {gossip_ports[i]}\npeers = [\"127.0.0.1:{router_gossip}\"]\n"
                    f"gossip_interval_s = {FLEET_GOSSIP_S}\nrecord_ttl_s = {FLEET_TTL_S}\n")
    router_cfg = os.path.join(tmp, "router.toml")
    with open(router_cfg, "w") as f:
        f.write(f"[server]\nhost = \"127.0.0.1\"\nport = {router_port}\n"
                f"\n[client]\nhosts = {json.dumps(hosts)}\nmodel_name = \"DCN\"\n"
                f"num_fields = {F}\ncandidate_num = {FLEET_N}\n"
                f"concurrent_num = {FLEET_EDGE[0] * FLEET_EDGE[1]}\ntimeout_s = 10.0\n"
                "health_scoreboard = true\nejection_failures = 1\nejection_interval_s = 1.0\n"
                "failover_attempts = 2\nbackoff_initial_ms = 10\nplacement = \"contiguous\"\n"
                f"\n[fleet]\nenabled = true\nself_id = \"router\"\ngossip_port = {router_gossip}\n"
                f"peers = {json.dumps([f'127.0.0.1:{p}' for p in gossip_ports])}\n"
                f"gossip_interval_s = {FLEET_GOSSIP_S}\nrecord_ttl_s = {FLEET_TTL_S}\n"
                f"rollout_writer = true\nrollout_state_file = \"{tmp}/rollout.json\"\n"
                + FLEET_ROUTER_TOML)

    logs = {}

    def spawn_replica(i: int, tag: str):
        path = os.path.join(out_dir, f"fleet_replica{i}{tag}.log")
        logf = open(path, "w")
        logs.setdefault(i, []).append(path)
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.serving.server", "--host", "127.0.0.1",
             "--port", str(ports[i]), "--config", os.path.join(tmp, f"replica{i}.toml"),
             "--model-base-path", base, "--rest-port", str(rest_ports[i]), "--fleet"],
            cwd=HERE, stdout=logf, stderr=subprocess.STDOUT)
        return proc, logf

    def serving(addr: str, proc) -> bool:
        if proc.poll() is not None:
            fail(f"fleet: {addr} exited with {proc.returncode} (logs {logs})")
        with grpc.insecure_channel(addr) as ch:
            st = health_proto.HealthStub(ch).Check(health_proto.HealthCheckRequest(""),
                                                   timeout=1.0).status
        return st == health_proto.SERVING

    def fleetz() -> dict:
        status, body = _get_json(router_gossip, "/fleetz")
        if status != 200:
            raise RuntimeError(f"/fleetz answered {status}")
        return body

    async def timed(client, payload, k: int) -> tuple[list, "np.ndarray"]:
        lat, got = [], None
        for _ in range(k):
            t0 = time.perf_counter()
            got = await client.predict(payload)
            lat.append((time.perf_counter() - t0) * 1e3)
        return lat, got

    async def probes(k: int) -> dict:
        """The same payload, traffic off: through the router, through the
        direct sharded client over the three replicas (contiguous: shard i
        to replica i, as the router splits it), and unsplit to one
        replica; scores and k sequential latencies of each."""
        out = {}
        async with ShardedPredictClient([router], "DCN", timeout_s=30.0) as edge, \
                ShardedPredictClient(hosts, "DCN", timeout_s=30.0) as direct, \
                ShardedPredictClient(hosts[:1], "DCN", timeout_s=30.0) as one:
            for label, client in (("router", edge), ("direct_3way", direct),
                                  ("one_replica", one)):
                lat, got = await timed(client, probe, k)
                out[label] = {"scores": got, **_percentiles(lat)}
        return out

    def check_scores(p: dict, when: str) -> dict:
        d, r = p["direct_3way"]["scores"], p["router"]["scores"]
        if d.shape != (FLEET_N,) or not np.all(np.isfinite(d)):
            fail(f"fleet {when}: direct sharded scores are not {FLEET_N} finite values")
        err = float(np.max(np.abs(d - want)))
        if err > FLEET_TOL:
            fail(f"fleet {when}: direct sharded scores {err:.3g} from the plain forward "
                 f"(tolerance {FLEET_TOL})")
        if r.dtype != d.dtype or r.tobytes() != d.tobytes():
            fail(f"fleet {when}: the router's scores are not the bits of the direct call of the "
                 f"same rows to the same replicas (max diff {float(np.max(np.abs(r - d))):.3g})")
        one_err = float(np.max(np.abs(p["one_replica"]["scores"] - want)))
        if one_err > FLEET_TOL:
            fail(f"fleet {when}: one replica's unsplit scores {one_err:.3g} from the plain "
                 f"forward")
        return {"max_abs_err": err, "one_replica_max_abs_err": one_err, "router_bits": True}

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    ready, start, stop = ctx.Queue(), ctx.Event(), ctx.Event()
    edges = []
    procs: dict = {}
    router_proc = router_log = None
    res = {"card": name, "replicas": FLEET_REPLICAS, "gossip_interval_s": FLEET_GOSSIP_S}
    try:
        # 1. The fleet: the replicas in parallel, then the router.
        t0 = time.perf_counter()
        for i in range(FLEET_REPLICAS):
            procs[i] = spawn_replica(i, "")
        for i in range(FLEET_REPLICAS):
            _poll(lambda i=i: serving(hosts[i], procs[i][0]), f"replica {i} SERVING")
        res["replicas_ready_s"] = time.perf_counter() - t0
        router_log_path = os.path.join(out_dir, "fleet_router.log")
        router_log = open(router_log_path, "w")
        router_proc = subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.serving.server", "--router", "--config", router_cfg],
            cwd=HERE, stdout=router_log, stderr=subprocess.STDOUT)
        _, converge_s = _poll(lambda: serving(router, router_proc)
                              and fleetz()["gossip"]["member_count"] >= FLEET_REPLICAS + 1,
                              "router SERVING with the whole membership")
        res["router_ready_s"] = converge_s
        log(f"fleet: {FLEET_REPLICAS} replicas SERVING in {res['replicas_ready_s']:.1f} s, the "
            f"router and its gossip view of {FLEET_REPLICAS + 1} members {converge_s:.1f} s later")

        # 2. Scores before the chaos, traffic off.
        pre = asyncio.run(probes(FLEET_PROBES))
        res["scores_pre"] = check_scores(pre, "before the chaos")
        res["latency_ms"] = {k: {q: v[q] for q in ("p50_ms", "p99_ms")} for k, v in pre.items()}
        lat = res["latency_ms"]
        log(f"fleet: n={FLEET_N} over gRPC ({name}): through the router p50 "
            f"{lat['router']['p50_ms']:.3f} / p99 {lat['router']['p99_ms']:.3f} ms; direct to one "
            f"replica p50 {lat['one_replica']['p50_ms']:.3f} / p99 "
            f"{lat['one_replica']['p99_ms']:.3f} ms; the 3-way direct fan-out p50 "
            f"{lat['direct_3way']['p50_ms']:.3f} ms against one replica unsplit "
            f"{lat['one_replica']['p50_ms']:.3f} ms; direct scores within "
            f"{res['scores_pre']['max_abs_err']:.3g} of the plain forward, the router's the "
            f"same bits")

        # 3. Edge traffic, then SIGKILL one replica.
        edges = [ctx.Process(target=_fleet_edge, daemon=True,
                             args=(k, router, FLEET_N, F, FLEET_EDGE[1], FLEET_EDGE_PAUSE_S,
                                   router_gossip, ready, start, stop, results))
                 for k in range(FLEET_EDGE[0])]
        for p in edges:
            p.start()
        import queue

        for _ in edges:
            try:
                ready.get(timeout=120)
            except queue.Empty:
                fail("fleet: the edge clients did not connect within 120 s")
        traffic_t = time.time()
        router_cpu0 = _cpu_seconds(router_proc.pid)
        start.set()
        time.sleep(FLEET_STEADY_S)
        victim = 1
        procs[victim][0].kill()
        procs[victim][0].wait()
        procs[victim][1].close()
        kill_t = time.time()
        time.sleep(FLEET_DOWN_S)

        # 4. The restart, under the same id: a gossip rejoin.
        restart_t = time.time()
        procs[victim] = spawn_replica(victim, "_restarted")

        def rejoined():
            fz = fleetz()
            rec = fz.get("gossip", {}).get("members", {}).get(hosts[victim])
            return fz if (rec and rec.get("state") == "serving"
                          and fz.get("healthy_backends") == FLEET_REPLICAS) else None

        # Polled at the gossip interval: the router answers /fleetz on the
        # threads that serve its gossip, so a faster poll loads the router
        # the phase is measuring.
        fz_rejoin, _ = _poll(rejoined, "gossip rejoin of the restarted replica",
                             every=FLEET_GOSSIP_S)
        res["rejoin_s"] = time.time() - restart_t
        if res["rejoin_s"] > REJOIN_BOUND_S:
            fail(f"fleet: the restarted replica rejoined in {res['rejoin_s']:.1f} s "
                 f"(bound {REJOIN_BOUND_S} s)")

        # The router's audits so far: every replica on v1, so one request
        # scored by two of them must give the same bits (checked below).
        audit_pre = fleetz()["counters"]

        # 5. The canary, then one replica's operator rollback, fleet-wide.
        vdir = os.path.join(base, "2")
        save_servable(vdir, Servable(name="DCN", version=2, model=model, params=params[2],
                                     signatures=ctr_signatures(F)), "dcn_v2")
        publish_t = time.time()
        for i in range(FLEET_REPLICAS):
            _poll(lambda i=i: _get_json(rest_ports[i], "/lifecyclez")[1].get("canary_version")
                  == 2, f"replica {i}'s canary v2", every=FLEET_GOSSIP_S)
        res["canary_live_s"] = time.time() - publish_t

        def post_rollback():
            status, body = _get_json(rest_ports[0], "/lifecyclez/rollback",
                                     {"reason": "fleet phase"})
            return body if status == 200 and body.get("rolled_back") else None

        _poll(post_rollback, "an accepted rollback of v2 on replica 0")
        rollback_t = time.time()
        _, res["router_blacklist_s"] = _poll(
            lambda: 2 in fleetz().get("rollout", {}).get("state", {}).get("blacklist", []),
            "the router's fleet blacklist of v2")
        blacklist_t = time.time()

        def all_rolled_back():
            states = [_get_json(rest_ports[i], "/lifecyclez")[1] for i in range(FLEET_REPLICAS)]
            return states if all(s.get("rolled_back_version") == 2 for s in states) else None

        states, _ = _poll(all_rolled_back, "v2 rolled back on every replica", every=0.02)
        res["propagation_s"] = time.time() - blacklist_t
        res["rollback_to_all_s"] = time.time() - rollback_t
        bound = FLEET_GOSSIP_S + PROPAGATION_SLACK_S
        if res["propagation_s"] > bound:
            fail(f"fleet: v2 reached the last replica's rollback {res['propagation_s']:.2f} s "
                 f"after the router's blacklist (bound {bound} s)")
        time.sleep(FLEET_AFTER_S)
        stop.set()
        recs, pushed = [], 0
        for _ in range(2 * len(edges)):
            got = results.get(timeout=120)
            if got and got[0] == "error":
                fail(f"fleet: an edge client failed: {got[1]}")
            if got and got[0] == "pushed":
                pushed += got[1]
            else:
                recs.extend(got)
        stop_t = time.time()
        router_cores = (_cpu_seconds(router_proc.pid) - router_cpu0) / (stop_t - traffic_t)
        with open(os.path.join(out_dir, "fleet_edge.json"), "w") as f:
            json.dump({"traffic_t": traffic_t, "kill_t": kill_t, "restart_t": restart_t,
                       "publish_t": publish_t, "stop_t": stop_t, "records": recs}, f)

        # The edge's view: errors, goodput, the kill's first rerouted answer.
        errors = [r for r in recs if r[2]]
        ok_times = sorted(r[1] for r in recs if not r[2])
        steady = _windows(ok_times, traffic_t + 1.0, kill_t - 0.2)
        chaos = _windows(ok_times, kill_t, publish_t - 0.2)
        rollout = _windows(ok_times, publish_t, stop_t - 0.2)
        median = statistics.median(steady) if steady else 0
        ratio = min(chaos) / median if chaos and median else None
        rerouted = min((r[1] for r in recs if not r[2] and r[0] >= kill_t), default=None)
        res["edge"] = {"requests": len(recs), "errors": len(errors),
                       "error_kinds": sorted({e[2] for e in errors})[:5],
                       "steady_windows": steady, "chaos_windows": chaos,
                       "rollout_windows": rollout, "steady_median": median,
                       "min_chaos_ratio": ratio, "spans_pushed": pushed,
                       "router_cpu_cores": router_cores,
                       "kill_to_first_rerouted_s": (rerouted - kill_t) if rerouted else None}
        if errors:
            fail(f"fleet: {len(errors)} of {len(recs)} edge Predicts failed: "
                 f"{res['edge']['error_kinds']}")
        if ratio is None or ratio < MIN_GOODPUT_RATIO:
            fail(f"fleet: goodput from the kill to the canary publish fell to {ratio} of the "
                 f"steady median {median}/s (windows {chaos}; bound {MIN_GOODPUT_RATIO})")
        # The audits over the canary and the rollback are counted, not
        # gated: there a replica may answer from v2.
        audit_all = fleetz()["counters"]
        res["audit"] = {"fraction": FLEET_AUDIT_FRACTION,
                        **{f"{k}_pre_publish": audit_pre[k] for k in (
                            "integrity_audits", "audit_disagreements", "audit_suspects_marked")},
                        **{k: audit_all[k] for k in (
                            "integrity_audits", "audit_disagreements", "audit_suspects_marked")}}
        if not audit_pre["integrity_audits"] > 0 or audit_pre["audit_disagreements"]:
            fail(f"fleet: before the canary publish the router ran "
                 f"{audit_pre['integrity_audits']} audits with "
                 f"{audit_pre['audit_disagreements']} mismatches (> 0 and none expected)")
        res["rollback"] = {"per_replica_rolled_back": [s.get("rolled_back_version")
                                                        for s in states]}
        log(f"fleet: {len(recs)} edge Predicts of n={FLEET_N} through the router, 0 failed; "
            f"the router's CPU {router_cores:.2f} cores; SIGKILL -> first rerouted answer "
            f"{res['edge']['kill_to_first_rerouted_s'] * 1e3:.1f} ms; goodput per 1 s "
            f"steady median {median}, kill..publish min {min(chaos)} (ratio {ratio:.3f}); "
            f"restart -> rejoin through gossip {res['rejoin_s']:.2f} s (healthy_backends "
            f"{fz_rejoin['healthy_backends']}); v2 live on all in {res['canary_live_s']:.2f} s; "
            f"rollback -> router blacklist {res['router_blacklist_s']:.2f} s -> last replica "
            f"{res['propagation_s']:.3f} s (gossip {FLEET_GOSSIP_S} s); router audits "
            f"before the publish {audit_pre['integrity_audits']}, 0 mismatched (over the "
            f"canary too: {audit_all['integrity_audits']}, "
            f"{audit_all['audit_disagreements']} mismatched)")

        # 6. Scores again, settled.
        res["scores_post"] = check_scores(asyncio.run(probes(1)), "after the rollback")

        # 7. The fleet's observability surfaces.
        def stitched():
            status, tz = _get_json(router_gossip, "/tracez?limit=100")
            three = [t for t in (tz.get("traces") or []) if t.get("num_processes", 0) >= 3
                     and t.get("stitched_hops", 0) >= 2 and t.get("waterfall")]
            return three

        three, _ = _poll(stitched, "a stitched trace of edge, router and replica", timeout=30.0)
        wf = three[0]["waterfall"]
        closed = sum(wf["components_us"].values()) + wf["other_us"]
        if wf["total_us"] <= 0 or abs(closed - wf["total_us"]) > max(
                WATERFALL_CLOSE_TOL * wf["total_us"], 1):
            fail(f"fleet: the hop waterfall does not close: {closed} against {wf['total_us']}")
        _, mon = _get_json(router_gossip, "/fleet/monitoring")
        agg_qps = float((mon.get("aggregate") or {}).get("qps") or 0.0)
        member_sum = sum(float(st.get("qps") or 0.0) for st in (mon.get("members") or {}).values())
        if member_sum <= 0 or abs(agg_qps - member_sum) > QPS_AGG_TOL * member_sum:
            fail(f"fleet: /fleet/monitoring qps {agg_qps} against its members' sum {member_sum}")
        _, slo = _get_json(router_gossip, "/sloz")
        burns = [v for wins in (slo.get("burn") or {}).values() for v in (wins or {}).values()]
        if not slo.get("enabled") or not burns or not all(
                isinstance(v, (int, float)) and math.isfinite(v) and v >= 0 for v in burns):
            fail(f"fleet: /sloz burn rates are not finite: {json.dumps(slo)[:400]}")
        _, router_prom = _get_json(router_gossip, "/metrics")
        _, replica_prom = _get_json(rest_ports[0], "/monitoring/prometheus/metrics")
        series = {"router": sum(1 for ln in router_prom.splitlines()
                                if ln.startswith("dts_tpu_fleet_")),
                  "replica": sum(1 for ln in replica_prom.splitlines()
                                 if ln.startswith("dts_tpu_fleet_"))}
        if not series["router"] or not series["replica"]:
            fail(f"fleet: dts_tpu_fleet_* series missing: {series}")
        _prom_lint(router_prom, "the router's /metrics")
        _prom_lint(replica_prom, "a replica's exposition")
        res["observability"] = {
            "three_process_traces": len(three), "num_processes": three[0]["num_processes"],
            "waterfall": wf, "agg_qps": agg_qps, "member_qps_sum": member_sum,
            "slo_burn": slo.get("burn"), "slo_breached": slo.get("breached"),
            "fleet_series": series}
        log(f"fleet: /tracez holds {len(three)} stitched traces of >= 3 processes (the first "
            f"{three[0]['num_processes']}, waterfall {closed} of {wf['total_us']} us); "
            f"/fleet/monitoring qps {agg_qps} against members' {member_sum:.3f}; /sloz burn "
            f"{json.dumps(slo.get('burn'))}; dts_tpu_fleet_* lines router {series['router']}, "
            f"replica {series['replica']}, lint clean")
    finally:
        stop.set()
        start.set()
        for p in edges:
            p.join(10)
            if p.is_alive():
                p.terminate()
        if router_proc is not None:
            if router_proc.poll() is None:
                router_proc.send_signal(signal.SIGTERM)
                try:
                    router_proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    router_proc.kill()
                    router_proc.wait()
            router_log.close()
        codes = {i: _stop_cli(*pl) for i, pl in procs.items()}
        shutil.rmtree(tmp, ignore_errors=True)

    # 8. Launches and devices, from each replica's log (the killed one's
    # first process logged no shutdown): the launches that served, every
    # version's warmup left out.
    launches, per_replica = {}, {}
    for i, paths in logs.items():
        for path in paths:
            with open(path) as f:
                if not re.search(r"device cuda", f.read()):
                    fail(f"fleet: {path} does not log device cuda")
        path = paths[-1]
        if _server_log(path)["shutdown"] is None:
            fail(f"fleet: {path} logged no launch counts at shutdown")
        counts = _served_launches(path)
        per_replica[os.path.basename(path)] = counts.get("fused_serve/bfloat16", 0)
        if counts.get("fused_serve/bfloat16", 0) <= 0:
            fail(f"fleet: {path}'s served requests launched no fused_serve/bfloat16: {counts}")
        for key, v in counts.items():
            launches[key] = launches.get(key, 0) + v
    if any(c != 0 for c in codes.values()) or router_proc.returncode != 0:
        fail(f"fleet: SIGTERM exits: replicas {codes}, router {router_proc.returncode}")
    res["launches"] = launches
    res["launches_per_replica"] = per_replica
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"fleet: served fused_serve/bfloat16 launches per replica (warmups left out) "
        f"{per_replica} (the restarted one's included); every replica on device cuda; "
        f"SIGTERM -> exit 0 on all; phase wall {res['phase_s']:.1f} s")
    return res


MESH_SIZES = (7, 1000, 2048)  # the reference-shaped Predicts of step 1 and 4
MESH_LOGICAL = ((2, 2), (4, 1), (1, 4))  # (data, model) meshes over cuda:0 of step 2
MESH_ROWS = (5, 1000, 2048)  # step 2's batch rows (5: the data-axis pad)
MESH_LADDER = ("4x1", "2x2", "1x4")  # step 3's split ladder over four logical shards
MESH_N = 1000  # candidates per Predict of the paced traffic
# Candidates per Predict of the elastic clients: the top bucket, so no two
# requests coalesce and each answer's bits are its split's alone.
MESH_ELASTIC_N = 2048
MESH_CLIENTS = 4  # the elastic closed loop's client processes
MESH_REPEATS = 20  # sequential Predicts per server for the p50 line
MESH_TIMED = 10  # executor calls per mesh for the ms-per-batch line
MESH_POLL_S = 0.25  # --file-system-poll-wait-seconds of the multi-process servers
MESH_PACE_S = 0.02  # the paced traffic's pause between Predicts during the RELOAD
MESH_HOLD_S = 1.0  # elastic traffic on each split before the next forced move
# The elastic clients' pause between Predicts once the load is let down:
# long enough that the queue is empty at most controller ticks.
MESH_SLOW_S = 0.5
MESH_WAIT_S = 60.0  # bound on each wait of the phase
MESH_DEATH_S = 20.0  # 2 x multihost_server.HEARTBEAT_TIMEOUT_S: a dead follower's bound
MESH_TP_RTOL = 1e-5  # TP against replicated, in f32 (the JAX test's)
MESH_ELASTIC = dict(splits=MESH_LADDER, tick_interval_s=0.05, dwell_s=0.5, up_after_ticks=2,
                    down_after_ticks=3)


def _mesh_client(k, port, payload, barrier, slow, stop, results) -> None:
    """One client process of the mesh phase's elastic closed loop (spawned):
    one channel, `payload` as Predicts back to back from the barrier until
    `stop`, MESH_SLOW_S apart once `slow` is set. Puts (answers, failures,
    {score bytes: [count, scores]}) or ("error", text) on `results`."""
    import traceback

    try:
        import grpc

        from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

        req = _request(payload["feat_ids"], payload["feat_wts"])
        ch = _channel(port)
        call = ch.unary_unary("/tensorflow.serving.PredictionService/Predict",
                              request_serializer=apis.PredictRequest.SerializeToString,
                              response_deserializer=apis.PredictResponse.FromString)
        grpc.channel_ready_future(ch).result(timeout=60)
        barrier.wait(timeout=120)
        ok = failed = 0
        seen: dict = {}
        while not stop.is_set():
            try:
                scores = _scores_of(call(req, timeout=60))
                ok += 1
                hit = seen.setdefault(scores.tobytes(), [0, scores])
                hit[0] += 1
            except grpc.RpcError:
                failed += 1
            if slow.is_set():
                time.sleep(MESH_SLOW_S)
        ch.close()
        results.put((ok, failed, seen))
    except BaseException:  # noqa: BLE001 — the parent fails the phase with it
        results.put(("error", traceback.format_exc()))


def _launch_lines(path: str) -> dict:
    """A server log's kernel launch counts: {"start": {...}, "shutdown": {...}}
    (the multi-process server and the CLI log both lines)."""
    import re

    out = {}
    with open(path) as f:
        for line in f:
            m = re.search(r"kernel launches at (start|shutdown): (\{.*\})$", line)
            if m:
                out[m.group(1)] = json.loads(m.group(2))
    return out


def _served(path: str, what: str) -> dict:
    """A server's launches from its start line to its shutdown line."""
    lines = _launch_lines(path)
    if "shutdown" not in lines:
        fail(f"mesh: {what} logged no kernel launches at shutdown ({path})")
    start = lines.get("start", {})
    return {k: n - start.get(k, 0) for k, n in lines["shutdown"].items() if n - start.get(k, 0)}


def row_count_step(dev) -> dict:
    """The eager products of the dcn_v2 forward at configs/latency.toml's
    width, 2048 rows, both dtypes (tools/torch_row_count.py probe): each
    product in calls of 2048 ... 250 rows as one library call (`mm`, the
    product before the fix) and in the fixed row tiles matmul_f32 runs
    (`tiled`), against the 2048-row call. Logs the products whose one call
    moves a row's bits, and by how much; fails if the tiled product or the
    whole forward (use_pallas_cross off and on) moves any."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_row_count", os.path.join(HERE, "tools", "torch_row_count.py"))
    probe_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe_mod)
    t0 = time.perf_counter()
    res = probe_mod.probe(dev, timed=False, methods=("mm", "tiled"))
    moved = {m: probe_mod.moved_products(res, m) for m in ("mm", "tiled")}
    forward = {cd: {k: {n: v["max_abs_diff"] for n, v in per.items() if v["rows_moved"]}
                    for k, per in r["forward"].items()} for cd, r in res.items()}
    out = {"moved_one_call": moved["mm"], "moved_tiled": moved["tiled"],
           "forward_moved": forward, "s": time.perf_counter() - t0}
    log(f"mesh: row counts: one library call per product moves a row's bits in "
        f"{len(moved['mm'])} of {sum(len(r['products']) for r in res.values())} "
        f"(dtype, product) pairs, max "
        f"{max((d for v in moved['mm'].values() for d in v.values()), default=0.0):.3g}: "
        f"{ {k: max(v.values()) for k, v in moved['mm'].items()} }; in fixed tiles: "
        f"{moved['tiled'] or 'none'}; the whole forward: "
        f"{ {cd: {k: v or 'none' for k, v in f.items()} for cd, f in forward.items()} }")
    if moved["tiled"] or any(v for f in forward.values() for v in f.values()):
        fail(f"mesh: a row's bits move with its call's row count: tiled {moved['tiled']}, "
             f"forward {forward}")
    return out


def phase_mesh(dev, name: str) -> dict:
    """Serving over a mesh on the card, configs/latency.toml's dcn_v2 (43 x
    16, vocab 2^20, MLP 256/128/64, 3 cross layers, bf16) with
    use_pallas_cross, from one save_servable checkpoint (seed 0; v2 seed
    1). Every server of step 1 and step 4 starts at once at the phase's
    start. Checks in the module docstring."""
    import multiprocessing
    import queue
    import re
    import shutil
    import signal
    import tempfile
    import threading

    import grpc
    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch import codec, faults
    from distributed_tf_serving_tpu_torch.client import make_payload
    from distributed_tf_serving_tpu_torch.models import Servable, build_model, ctr_signatures
    from distributed_tf_serving_tpu_torch.ops import cross_kernel as ck
    from distributed_tf_serving_tpu_torch.ops.transfer import restore_outputs_host
    from distributed_tf_serving_tpu_torch.parallel import ShardedExecutor, make_mesh
    from distributed_tf_serving_tpu_torch.parallel.mesh import row_blocks
    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host
    from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server
    from distributed_tf_serving_tpu_torch.train.checkpoint import load_servable, save_servable
    from distributed_tf_serving_tpu_torch.utils.config import (
        ElasticConfig,
        MeshConfig,
        OverloadConfig,
        load_config,
    )
    from distributed_tf_serving_tpu_torch.utils.metrics import ServerMetrics

    t_phase = time.perf_counter()
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(HERE, "configs", "latency.toml")) as f:
        text, k = re.subn(r"(?m)^\[model\]\n", "[model]\nuse_pallas_cross = true\n", f.read())
    if k != 1:
        fail("configs/latency.toml has no [model] section")
    tmp = tempfile.mkdtemp(prefix="dts_mesh_")
    plain_toml = os.path.join(tmp, "plain.toml")
    mesh_toml = os.path.join(tmp, "mesh.toml")
    with open(plain_toml, "w") as f:
        f.write(text)
    with open(mesh_toml, "w") as f:
        f.write(text + "\n[mesh]\nenabled = true\ndevices = 1\n")
    cfgs = load_config(plain_toml)
    cfg, mc = cfgs["server"], cfgs["model"]
    F, V = mc.num_fields, mc.vocab_size
    model = build_model("dcn_v2", mc)
    params = {v: model.init(v - 1, "cpu") for v in (1, 2)}
    bases = {}
    for tag in ("a", "b"):  # b: the RELOAD pair's own, which gets v2
        bases[tag] = os.path.join(tmp, f"models_{tag}")
        save_servable(os.path.join(bases[tag], "1"), Servable(
            name="DCN", version=1, model=model, params=params[1], signatures=ctr_signatures(F)),
            "dcn_v2")
    ckpt = os.path.join(bases["a"], "1")
    buckets = ",".join(str(b) for b in cfg.buckets)
    pay = {n: make_payload(n, F, seed=SEED + 5000 + n) for n in MESH_SIZES}
    res: dict = {"card": name}
    procs: dict = {}  # tag -> (process, log file, log path)

    def spawn(tag: str, argv: list[str]):
        path = os.path.join(out_dir, f"mesh_{tag}.log")
        logf = open(path, "w")
        procs[tag] = (subprocess.Popen([sys.executable, "-m", *argv], cwd=HERE, stdout=logf,
                                       stderr=subprocess.STDOUT), logf, path)

    def multihost(tag: str, n: int, pid: int, coord: int, port: int, base: str):
        spawn(tag, [f"{PKG}.serving.multihost_server", "--model-base-path", base,
               "--num-processes", str(n), "--process-id", str(pid), "--coordinator",
               f"127.0.0.1:{coord}", "--host", "127.0.0.1", "--port", str(port),
               "--buckets", buckets, "--file-system-poll-wait-seconds", str(MESH_POLL_S)])

    def ready(port: int, tag: str) -> float:
        """Seconds until the server on `port` answers GetModelMetadata; the
        run fails if its process exits first or the wait runs out."""
        from distributed_tf_serving_tpu_torch.proto import serving_apis_pb2 as apis

        t0 = time.perf_counter()
        with _channel(port) as ch:
            stub = PredictionServiceStub(ch)
            while True:
                if procs[tag][0].poll() is not None:
                    fail(f"mesh: {tag} exited with {procs[tag][0].returncode} before it "
                         f"answered (log {procs[tag][2]})")
                try:
                    stub.GetModelMetadata(apis.GetModelMetadataRequest(
                        model_spec=apis.ModelSpec(name="DCN")), timeout=2)
                    return time.perf_counter() - t0
                except grpc.RpcError:
                    if time.perf_counter() - t0 > 3 * MESH_WAIT_S:
                        fail(f"mesh: {tag} did not answer within {3 * MESH_WAIT_S} s")
                    time.sleep(0.2)

    def stop(tag: str, sig=signal.SIGTERM, timeout: float = MESH_WAIT_S) -> int:
        proc, logf, _ = procs[tag]
        if proc.poll() is None:
            proc.send_signal(sig)
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
                fail(f"mesh: {tag} did not exit within {timeout} s of {sig!r}")
        logf.close()
        return proc.returncode

    def predict(port: int, payload) -> "np.ndarray":
        with _channel(port) as ch:
            scores = _scores_of(PredictionServiceStub(ch).Predict(
                _request(payload["feat_ids"], payload["feat_wts"]), timeout=120))
        if scores.shape != payload["feat_ids"].shape[:1] or not np.all(np.isfinite(scores)):
            fail(f"mesh: a Predict of {payload['feat_ids'].shape[0]} rows on port {port} "
                 f"answered {scores.shape} / non-finite scores")
        return scores

    def on_card(p):
        return {"embedding": p["embedding"].to(dev),
                **{k: [{n: t.to(dev) for n, t in layer.items()} for layer in p[k]]
                   for k in ("cross", "mlp")},
                "out": {n: t.to(dev) for n, t in p["out"].items()}}

    card = {1: on_card(params[1])}

    def reference(version: int, payload, data: int, bucket: int, mdl=None) -> "np.ndarray":
        """The bits a path must answer: the rows padded to `bucket` (the
        batcher's pad) and the data axis, each data shard's block in its own
        call on the card, in shard order (data = 1: the plain server's)."""
        mdl = mdl or model
        n = payload["feat_ids"].shape[0]
        rows = bucket + (-bucket) % data
        ids = np.zeros((rows, F), np.int32)
        wts = np.zeros((rows, F), np.float32)
        ids[:n] = fold_ids_host(payload["feat_ids"], V)
        wts[:n] = payload["feat_wts"]
        ids_d, wts_d = torch.from_numpy(ids).to(dev), torch.from_numpy(wts).to(dev)
        with torch.inference_mode():
            parts = [mdl.apply(card[version], {"feat_ids": ids_d[lo:hi], "feat_wts": wts_d[lo:hi]})
                     ["prediction_node"] for lo, hi in row_blocks(rows, data)]
        return torch.cat(parts)[:n].float().cpu().numpy()

    def bucket_of(n: int) -> int:
        return next(b for b in cfg.buckets if n <= b)

    faults_seen: list = []

    def against(got, per_shard, plain, what: str) -> dict:
        """`got` must be the per-shard reference's bits; against the plain
        (whole-bucket) bits it is recorded (single_device)."""
        if got.tobytes() != per_shard.tobytes():
            fail(f"mesh: {what} is not the bits of its shards scored on the card "
                 f"(max diff {float(np.max(np.abs(got - per_shard))):.3g})")
        return single_device(got, plain, what)

    def single_device(got, plain, what: str) -> dict:
        """`got` must be the single-device bits: a row's bits do not move
        with its shard's row count (models/base.py ROW_TILE)."""
        same = got.tobytes() == plain.tobytes()
        err = float(np.max(np.abs(got - plain)))
        if not same:
            faults_seen.append({"what": what, "max_abs_diff": err})
            fail(f"mesh: {what} is not the single-device bits (max diff {err:.3g})")
        return {"bits_equal_single_device": same, "max_abs_diff": err}

    def bits(a, b, what: str) -> None:
        if a.tobytes() != b.tobytes():
            fail(f"mesh: {what}: not the same bits (max diff "
                 f"{float(np.max(np.abs(a - b))):.3g})")

    def save() -> None:
        """The results so far, in chiprun_out/mesh.json (read when a later
        step fails)."""
        with open(os.path.join(out_dir, "mesh.json"), "w") as f:
            json.dump(res, f, indent=1, default=str)

    ctx = multiprocessing.get_context("spawn")
    plain_server = elastic_server = None
    plain_batcher = elastic_batcher = None
    clients: list = []
    try:
        # 0. Every server at once: the [mesh] CLI (devices = 1), the
        # multi-process tier at NCCL world size 1, the gloo pair of the
        # RELOAD / SHUTDOWN run and the gloo pair whose follower dies.
        ports = {t: _free_port() for t in ("cli", "rest", "mh1", "mh2", "mh3")}
        coords = {t: _free_port() for t in ("mh1", "mh2", "mh3")}
        spawn("cli", [f"{PKG}.serving.server", "--host", "127.0.0.1", "--port",
                      str(ports["cli"]), "--config", mesh_toml, "--checkpoint", ckpt,
                      "--rest-port", str(ports["rest"])])
        multihost("mh1", 1, 0, coords["mh1"], ports["mh1"], bases["a"])
        for pid in (0, 1):
            multihost(f"mh2_{pid}", 2, pid, coords["mh2"], ports["mh2"], bases["b"])
            multihost(f"mh3_{pid}", 2, pid, coords["mh3"], ports["mh3"], bases["a"])
        res["row_count"] = row_count_step(dev)
        save()

        # 1. The plain server in this process: the same checkpoint through
        # model.apply (fused_kernel off), so both launch the cross stack.
        plain_impl, plain_batcher, _sv = build_stack(
            dataclasses.replace(cfg, warmup=True), mc, "cuda", seed=SEED, fused_kernel=False,
            checkpoint=ckpt)
        plain_server, plain_port = create_server(plain_impl, "127.0.0.1:0")
        plain_server.start()
        ck.reset_launches()
        plain_scores = {n: predict(plain_port, pay[n]) for n in MESH_SIZES}
        plain_launches = _launch_counts()
        for n in MESH_SIZES:
            bits(plain_scores[n], reference(1, pay[n], 1, bucket_of(n)),
                 f"the plain server's n={n}")
        if plain_launches["fused_cross_apply/bfloat16"] < len(MESH_SIZES) or any(
                v for k, v in plain_launches.items() if k.startswith("fused_serve")):
            fail(f"mesh: the plain server's Predicts launched {plain_launches}")
        res["cli_ready_s"] = ready(ports["cli"], "cli")
        for n in MESH_SIZES:
            bits(predict(ports["cli"], pay[n]), plain_scores[n],
                 f"the [mesh] server's n={n} against the plain server's")
        res["step1"] = {"bits_equal_plain": list(MESH_SIZES), "launches_plain": plain_launches}
        log(f"mesh: step 1 ({name}): the [mesh] server (devices = 1) answered n = "
            f"{'/'.join(map(str, MESH_SIZES))} with the plain server's bits")
        save()

        # 2. Logical meshes over cuda:0, in process: EP over (2, 2) and
        # (1, 4), rows over (4, 1), against the card's single-device bits.
        sv = load_servable(ckpt, device=dev)
        step2: dict = {}
        mesh_launches = {"fused_cross_apply/bfloat16": 0, "fused_cross_apply/float32": 0}
        for d, m in MESH_LOGICAL:
            ex = ShardedExecutor(make_mesh(d * m, m, devices=[dev] * (d * m)))
            for rows in MESH_ROWS:
                p = make_payload(rows, F, seed=SEED + 6000 + rows)
                arrays = {"feat_ids": fold_ids_host(p["feat_ids"], V), "feat_wts": p["feat_wts"]}
                ck.reset_launches()
                got = ex(sv, arrays, out_keys=("prediction_node",))["prediction_node"]
                got = got.float().cpu().numpy()
                n_launch = ck.launches[("fused_cross_apply", "bfloat16")]
                mesh_launches["fused_cross_apply/bfloat16"] += n_launch
                if n_launch != d:
                    fail(f"mesh: the ({d}, {m}) mesh launched the cross stack {n_launch} times "
                         f"for {d} shard forwards")
                unfiltered = ex(sv, arrays)["prediction_node"].float().cpu().numpy()
                bits(unfiltered, got, f"({d}, {m}) rows {rows} unfiltered against filtered")
                step2[f"{d}x{m}/{rows}"] = against(got, reference(1, p, d, rows),
                                                   reference(1, p, 1, rows),
                                                   f"the ({d}, {m}) mesh at {rows} rows")
        p5 = make_payload(5, F, seed=SEED + 6005)
        a5 = {"feat_ids": fold_ids_host(p5["feat_ids"], V), "feat_wts": p5["feat_wts"]}
        ex8 = ShardedExecutor(make_mesh(4, 2, devices=[dev] * 4), output_wire_dtype="int8")
        q = ex8(sv, a5, out_keys=("prediction_node",))
        wire = restore_outputs_host({k: v.cpu().numpy() for k, v in q.items()})["prediction_node"]
        qs, scale, mn = _q8_host(reference(1, p5, 2, 5))
        bits(wire, codec.dequantize_scores(qs, scale, mn),
             "the int8 wire over the pad (5 rows on 2 data shards)")
        # TP at (2, 2) in f32: the f32 cross-stack kernel under the weight
        # all-gather, against the replicated layout.
        mdl32 = build_model("dcn_v2", dataclasses.replace(mc, compute_dtype="float32"))
        sv32 = dataclasses.replace(sv, model=mdl32)
        mesh22 = make_mesh(4, 2, devices=[dev] * 4)
        p = make_payload(1000, F, seed=SEED + 7000)
        arrays = {"feat_ids": fold_ids_host(p["feat_ids"], V), "feat_wts": p["feat_wts"]}
        ck.reset_launches()
        tp = ShardedExecutor(mesh22, tensor_parallel=True)(sv32, arrays)["prediction_node"]
        if ck.launches[("fused_cross_apply", "float32")] != 2:
            fail(f"mesh: TP at (2, 2) launched the f32 cross stack "
                 f"{ck.launches[('fused_cross_apply', 'float32')]} times for 2 shard forwards")
        mesh_launches["fused_cross_apply/float32"] += 2
        rep = ShardedExecutor(mesh22)(sv32, arrays)["prediction_node"]
        tp, rep = tp.cpu().numpy(), rep.cpu().numpy()
        if not np.allclose(tp, rep, rtol=MESH_TP_RTOL, atol=0):
            fail(f"mesh: TP at (2, 2) in f32 is {float(np.max(np.abs(tp - rep))):.3g} from the "
                 f"replicated layout (rtol {MESH_TP_RTOL})")
        step2["tp_2x2_f32"] = {"bits_equal_replicated": tp.tobytes() == rep.tobytes(),
                               "max_abs_diff": float(np.max(np.abs(tp - rep)))}
        # ms per batch of 2048 rows: the (2, 2) mesh against one device.
        p = make_payload(2048, F, seed=SEED + 8000)
        arrays = {"feat_ids": fold_ids_host(p["feat_ids"], V), "feat_wts": p["feat_wts"]}
        timed = {}
        for label, ex in (("mesh_2x2", ShardedExecutor(mesh22)),
                          ("one_device", ShardedExecutor(make_mesh(1, 1, devices=[dev]))),
                          ("mesh_2x2_again", ShardedExecutor(mesh22))):
            ex(sv, arrays, out_keys=("prediction_node",))  # placement
            torch.cuda.synchronize()
            ms = []
            for _ in range(MESH_TIMED):
                t0 = time.perf_counter()
                ex(sv, arrays, out_keys=("prediction_node",))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            timed[label] = statistics.median(ms)
        step2["ms_per_batch_2048"] = timed
        res["step2"] = step2
        moved = {k: v["max_abs_diff"] for k, v in step2.items()
                 if "/" in k and not v["bits_equal_single_device"]}
        log(f"mesh: step 2: the rows whose bits moved with the shard row count: {moved}")
        log(f"mesh: step 2 ({name}): logical meshes (2, 2) / (4, 1) / (1, 4) on cuda:0 at rows "
            f"{'/'.join(map(str, MESH_ROWS))}: the per-shard bits, single-device bits "
            f"{sum(v['bits_equal_single_device'] for k, v in step2.items() if '/' in k)}"
            f"/{len(MESH_LOGICAL) * len(MESH_ROWS)}; int8 wire exact over the pad; TP (2, 2) "
            f"f32 max diff {step2['tp_2x2_f32']['max_abs_diff']:.3g}; 2048 rows "
            f"{timed['mesh_2x2']:.3f} ms at (2, 2) against {timed['one_device']:.3f} ms on one "
            f"device")
        save()
        del sv, sv32

        # 3. Elastic under load: the ladder over four logical shards of
        # cuda:0 from its latency end (1, 4), a closed loop of spawned
        # clients, switches up forced through the `pressure` fault site
        # (BROWNOUT), then down, rung by rung, with the pressure pinned
        # NOMINAL and the clients paced so the queue runs light.
        e_impl, elastic_batcher, _e_sv = build_stack(
            dataclasses.replace(cfg, warmup=True), mc, "cuda", seed=SEED, checkpoint=ckpt,
            mesh_config=MeshConfig(enabled=True, devices=4, model_parallel=4),
            elastic_config=ElasticConfig(enabled=True, **MESH_ELASTIC),
            overload_config=OverloadConfig(enabled=True), mesh_device_list=[dev] * 4)
        elastic_server, e_port = create_server(e_impl, "127.0.0.1:0")
        elastic_server.start()
        e_pay = [make_payload(MESH_ELASTIC_N, F, seed=SEED + 9000 + k)
                 for k in range(MESH_CLIENTS)]
        results = ctx.Queue()
        barrier, slow, stop_evt = ctx.Barrier(MESH_CLIENTS + 1), ctx.Event(), ctx.Event()
        clients = [ctx.Process(target=_mesh_client, daemon=True,
                               args=(k, e_port, e_pay[k], barrier, slow, stop_evt, results))
                   for k in range(MESH_CLIENTS)]
        for c in clients:
            c.start()
        barrier.wait(timeout=120)
        ck.reset_launches()
        elastic = e_impl.elastic.executor

        def wait_split(want):
            t0 = time.perf_counter()
            while elastic.current_split != want:
                if time.perf_counter() - t0 > MESH_WAIT_S:
                    es = e_impl.elastic_stats()
                    fail(f"mesh: no elastic switch to {want} within {MESH_WAIT_S} s: current "
                         f"{es['current_split']}, controller {es.get('controller')}, history "
                         f"{es['history']}, overload {e_impl.overload_stats()}")
                e_impl.elastic_stats()  # a scrape ticks the controller too
                time.sleep(0.05)
            time.sleep(MESH_HOLD_S)

        # Up to the throughput end under the full loop and BROWNOUT, then
        # down to the latency end with the pressure pinned NOMINAL and the
        # clients paced: every rung is crossed both ways.
        faults.get().add("pressure", kind="error", code="BROWNOUT")
        wait_split((4, 1))
        faults.reset()
        faults.get().add("pressure", kind="error", code="NOMINAL")
        slow.set()
        wait_split((1, 4))
        stop_evt.set()
        answers, failed, seen = 0, 0, {}
        for _ in clients:
            try:
                got = results.get(timeout=MESH_WAIT_S)
            except queue.Empty:
                fail("mesh: an elastic client did not report")
            if got[0] == "error":
                fail(f"mesh: an elastic client failed:\n{got[1]}")
            answers += got[0]
            failed += got[1]
            for key, (count, scores) in got[2].items():
                seen.setdefault(key, [0, scores])[0] += count
        faults.reset()
        elastic_launches = _launch_counts()
        for k, v in elastic_launches.items():
            mesh_launches[k] = mesh_launches.get(k, 0) + v
        if failed:
            fail(f"mesh: {failed} of {answers + failed} Predicts failed across the switches")
        refs = {}
        for k, p in enumerate(e_pay):
            per_split = {s: reference(1, p, s[0], MESH_ELASTIC_N)
                         for s in ((4, 1), (2, 2), (1, 4))}
            refs[k] = per_split
        scores_by_split: dict = {}
        for _key, (count, scores) in seen.items():
            match = [(k, s) for k, per in refs.items() for s, r in per.items()
                     if r.tobytes() == scores.tobytes()]
            if not match:
                fail("mesh: an elastic answer is not the bits of any split's shards for its "
                     "payload")
            for k, s in match:
                scores_by_split.setdefault(f"{s[0]}x{s[1]}", 0)
                scores_by_split[f"{s[0]}x{s[1]}"] += count
        # 1x4 has one data shard: the single-device bits.
        across = {f"{k}/{s[0]}x{s[1]}": single_device(
            per[s], per[(1, 4)], f"elastic payload {k} on the {s[0]}x{s[1]} split")
            for k, per in refs.items() for s in ((4, 1), (2, 2))}
        es = e_impl.elastic_stats()
        moves = [(h["from"], h["to"]) for h in es["history"]]
        if moves != [("1x4", "2x2"), ("2x2", "4x1"), ("4x1", "2x2"), ("2x2", "1x4")]:
            fail(f"mesh: the elastic ladder moved {moves}, not up and down one rung at a time")
        drains = [h["drain_s"] for h in es["history"]]
        if any(d is None for d in drains):
            fail(f"mesh: the switches' drains were not all recorded: {es['history']}")
        _prom_lint(ServerMetrics().prometheus_text(
            elastic_batcher.stats, mesh=e_impl.mesh_stats(), elastic=es),
            "the elastic stack's dts_tpu_elastic_* series")
        res["step3"] = {"answers": answers, "failed": failed, "moves": moves,
                        "answers_by_split": scores_by_split,
                        "history": es["history"], "drain_s": drains,
                        "launches": elastic_launches, "bits_across_splits": across}
        log(f"mesh: step 3 ({name}): {answers} Predicts through "
            f"{' -> '.join(['1x4'] + [t for _f, t in moves])}, 0 failed; drains "
            f"{', '.join(f'{d:.4f}' for d in drains)} s; launches {elastic_launches}")
        save()
        elastic_server.stop(0)
        elastic_server = None
        elastic_batcher.stop()
        elastic_batcher = None

        # 4. The multi-process tier. (a) NCCL at world size 1.
        res["mh1_ready_s"] = ready(ports["mh1"], "mh1")
        for n in MESH_SIZES:
            bits(predict(ports["mh1"], pay[n]), plain_scores[n],
                 f"the multi-process server (NCCL, world 1) n={n} against the plain server's")
        if "joined (nccl)" not in open(procs["mh1"][2]).read():
            fail(f"mesh: the world-1 multi-process server did not join over NCCL "
                 f"({procs['mh1'][2]})")
        if stop("mh1") != 0:
            fail(f"mesh: the world-1 multi-process server exited nonzero ({procs['mh1'][2]})")
        mh_launches = {"mh1": _served(procs["mh1"][2], "the world-1 multi-process server")}
        # (b) Two gloo processes on cuda:0: scores, a RELOAD to v2 under
        # paced traffic, SHUTDOWN releasing the follower.
        res["mh2_ready_s"] = ready(ports["mh2"], "mh2_0")
        for tag in ("mh2_0", "mh2_1"):
            if "joined (gloo)" not in open(procs[tag][2]).read():
                fail(f"mesh: {tag} did not join over gloo ({procs[tag][2]})")
        mh2 = {}
        for n in MESH_SIZES:
            got = predict(ports["mh2"], pay[n])
            mh2[n] = against(got, reference(1, pay[n], 2, bucket_of(n)), plain_scores[n],
                             f"the gloo pair's n={n}")
        card[2] = on_card(params[2])
        want2 = reference(2, pay[MESH_N], 2, bucket_of(MESH_N))
        paced = {"ok": 0, "failed": 0, "v2_at": None}
        done = threading.Event()

        def pace():
            with _channel(ports["mh2"]) as ch:
                stub = PredictionServiceStub(ch)
                req = _request(pay[MESH_N]["feat_ids"], pay[MESH_N]["feat_wts"])
                while not done.is_set():
                    try:
                        s = _scores_of(stub.Predict(req, timeout=60))
                        paced["ok"] += 1
                        if paced["v2_at"] is None and s.tobytes() == want2.tobytes():
                            paced["v2_at"] = time.perf_counter()
                    except grpc.RpcError:
                        paced["failed"] += 1
                    time.sleep(MESH_PACE_S)

        pacer = threading.Thread(target=pace, daemon=True)
        pacer.start()
        time.sleep(0.5)
        t_write = time.perf_counter()
        save_servable(os.path.join(bases["b"], "2"), Servable(
            name="DCN", version=2, model=model, params=params[2], signatures=ctr_signatures(F)),
            "dcn_v2")
        t_written = time.perf_counter()
        _poll(lambda: paced["v2_at"], "v2's scores from the gloo pair", timeout=MESH_WAIT_S,
              phase="mesh")
        time.sleep(0.5)
        done.set()
        pacer.join(timeout=MESH_WAIT_S)
        if paced["failed"]:
            fail(f"mesh: {paced['failed']} of {paced['ok'] + paced['failed']} paced Predicts "
                 "failed across the RELOAD")
        t_stop = time.perf_counter()
        rc_leader = stop("mh2_0")
        proc1 = procs["mh2_1"][0]
        try:
            proc1.wait(timeout=MESH_WAIT_S)
        except subprocess.TimeoutExpired:
            fail("mesh: the follower was not released by the leader's SHUTDOWN")
        procs["mh2_1"][1].close()
        rc_follower = proc1.returncode
        released_s = time.perf_counter() - t_stop
        if rc_leader != 0 or rc_follower != 0:
            fail(f"mesh: the gloo pair exited {rc_leader} / {rc_follower} after SIGTERM "
                 f"(logs {procs['mh2_0'][2]}, {procs['mh2_1'][2]})")
        mh_launches["mh2_0"] = _served(procs["mh2_0"][2], "the gloo leader")
        mh_launches["mh2_1"] = _launch_lines(procs["mh2_1"][2]).get("shutdown", {})
        for tag in ("mh1", "mh2_0", "mh2_1"):
            if mh_launches[tag].get("fused_cross_apply/bfloat16", 0) < 1:
                fail(f"mesh: {tag} launched no cross stack: {mh_launches[tag]}")
        # (c) A SIGKILLed follower fails the leader fast.
        res["mh3_ready_s"] = ready(ports["mh3"], "mh3_0")
        predict(ports["mh3"], pay[7])
        t_kill = time.perf_counter()
        procs["mh3_1"][0].kill()
        procs["mh3_1"][0].wait(timeout=30)
        procs["mh3_1"][1].close()
        leader = procs["mh3_0"][0]
        try:
            leader.wait(timeout=MESH_DEATH_S)
        except subprocess.TimeoutExpired:
            fail(f"mesh: the leader outlived its SIGKILLed follower by {MESH_DEATH_S} s")
        death_s = time.perf_counter() - t_kill
        procs["mh3_0"][1].close()
        if leader.returncode == 0:
            fail("mesh: the leader exited 0 after its follower died")
        for k, v in mh_launches.items():
            for kk, n in v.items():
                mesh_launches[kk] = mesh_launches.get(kk, 0) + n
        res["step4"] = {"gloo_pair": mh2, "paced": {"ok": paced["ok"], "failed": paced["failed"]},
                        "reload_s": paced["v2_at"] - t_written, "write_s": t_written - t_write,
                        "follower_released_s": released_s, "follower_death_exit_s": death_s,
                        "leader_rc_after_death": leader.returncode, "launches": mh_launches}
        log(f"mesh: step 4 ({name}): NCCL world 1 answered the plain server's bits; the gloo "
            f"pair served (single-device bits {sum(v['bits_equal_single_device'] for v in mh2.values())}"
            f"/{len(MESH_SIZES)}), reloaded v2 {res['step4']['reload_s']:.3f} s after the write "
            f"with 0 of {paced['ok']} paced Predicts failed, released its follower "
            f"{released_s:.3f} s after SIGTERM; a SIGKILLed follower took its leader down "
            f"(rc {leader.returncode}) in {death_s:.3f} s")

        # 5. With every other process gone: the Predict latency of the
        # [mesh] server against the plain one (in turns), its /meshz and
        # dts_tpu_mesh_* series, then its served launches.
        lat: dict = {"plain": [], "mesh": []}
        for label, port in (("plain", plain_port), ("mesh", ports["cli"]), ("mesh", ports["cli"]),
                            ("plain", plain_port)):
            with _channel(port) as ch:
                stub = PredictionServiceStub(ch)
                req = _request(pay[1000]["feat_ids"], pay[1000]["feat_wts"])
                for _ in range(MESH_REPEATS // 2):
                    t0 = time.perf_counter()
                    stub.Predict(req, timeout=60)
                    lat[label].append((time.perf_counter() - t0) * 1e3)
        res["p50_ms_n1000"] = {k: statistics.median(v) for k, v in lat.items()}
        res["latency_ms_n1000"] = lat
        (status, meshz), _ = _poll(lambda: _get_json(ports["rest"], "/meshz"),
                                   "/meshz answer", timeout=MESH_WAIT_S, phase="mesh")
        if (status != 200 or not meshz.get("enabled") or meshz["shape"] != {"data": 1, "model": 1}
                or meshz["executor"]["batches"] < 1
                or meshz["executor"]["layout"].get("DCN") != "rules:dcn_v2"):
            fail(f"mesh: /meshz answered {status} {meshz}")
        status, prom = _get_json(ports["rest"], "/monitoring/prometheus/metrics")
        if status != 200 or "dts_tpu_mesh_batches_total" not in prom:
            fail("mesh: the [mesh] server's Prometheus text has no dts_tpu_mesh_* series")
        _prom_lint(prom, "the [mesh] server's exposition")
        if stop("cli") != 0:
            fail(f"mesh: the [mesh] server exited nonzero (log {procs['cli'][2]})")
        cli_launches = _served(procs["cli"][2], "the [mesh] server")
        if cli_launches.get("fused_cross_apply/bfloat16", 0) < len(MESH_SIZES) + MESH_REPEATS \
                or any(k.startswith("fused_serve") for k in cli_launches):
            fail(f"mesh: the [mesh] server's Predicts launched {cli_launches}")
        for k, n in cli_launches.items():
            mesh_launches[k] = mesh_launches.get(k, 0) + n
        res["step5"] = {"meshz": meshz, "launches_mesh_server": cli_launches}
        log(f"mesh: step 5 ({name}): n=1000 p50 {res['p50_ms_n1000']['mesh']:.3f} ms on the "
            f"[mesh] server against {res['p50_ms_n1000']['plain']:.3f} ms plain (in turns, over "
            f"gRPC); /meshz {meshz['shape']}, {meshz['executor']['batches']} batches; the "
            f"[mesh] server's served launches {cli_launches} (plain {plain_launches})")
        save()
    finally:
        faults.reset()
        for c in clients:
            if c.is_alive():
                c.kill()
        for srv in (plain_server, elastic_server):
            if srv is not None:
                srv.stop(0)
        for b in (plain_batcher, elastic_batcher):
            if b is not None:
                b.stop()
        for tag, (proc, logf, _) in procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            logf.close()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    res["row_count_faults"] = faults_seen
    res["launches"] = mesh_launches
    res["phase_s"] = time.perf_counter() - t_phase
    save()
    if res["phase_s"] > 90:
        log(f"mesh: the phase took {res['phase_s']:.1f} s (over its 90 s)")
    return res


TRAINMESH_STEPS = 20  # train steps of every run, from the same params on the same stream
TRAINMESH_BATCH = 2048  # rows per step (the top serving bucket)
# (data, model) meshes over cuda:0 and tensor_parallel; None: one device.
TRAINMESH_RUNS = ((None, False), ((4, 1), False), ((2, 2), False), ((1, 4), False),
                  ((2, 2), True))
# Per-step loss against the single-device run: f32 at the JAX test's rel
# 2e-4 (tests/test_train.py:93). bf16 rounds every activation to 8 bits of
# mantissa, so the f32-ulp differences of the data-axis gradient sum can
# flip a bf16 rounding after an update: held to rel 1e-3, the
# single-device bf16 trajectory bound of tests/test_torch_train.py.
TRAINMESH_RTOL = {"float32": 2e-4, "bfloat16": 1e-3}
TRAINMESH_SERVE = (1000, 2048)  # Predict sizes the mesh-trained snapshot serves
TRAINMESH_CLI_STEPS = 20  # the trainer CLI's --mesh-devices 1 run


def phase_trainmesh(dev, name: str) -> dict:
    """Training over a mesh on the card (train/trainer.py mesh=,
    tensor_parallel=): configs/latency.toml's dcn_v2 width (43 x 16, vocab
    2^20, 3 cross layers, MLP 256/128/64), seed-0 params, the synthetic
    stream, TRAINMESH_STEPS steps of TRAINMESH_BATCH rows, in f32 and bf16:
    one device, then logical meshes of cuda:0 (4, 1) dp, (2, 2) dp + ep,
    (1, 4) ep and (2, 2) with tensor_parallel. Checks in the module
    docstring."""
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    from distributed_tf_serving_tpu_torch.client import make_payload
    from distributed_tf_serving_tpu_torch.models import Servable, build_model
    from distributed_tf_serving_tpu_torch.models.registry import model_signatures
    from distributed_tf_serving_tpu_torch.parallel import MODEL_AXIS, ShardedExecutor, make_mesh
    from distributed_tf_serving_tpu_torch.parallel.mesh import P
    from distributed_tf_serving_tpu_torch.parallel.sharding import gather_params, placed_leaves
    from distributed_tf_serving_tpu_torch.proto import PredictionServiceStub
    from distributed_tf_serving_tpu_torch.serving.batcher import fold_ids_host
    from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server
    from distributed_tf_serving_tpu_torch.train import Trainer
    from distributed_tf_serving_tpu_torch.train.checkpoint import load_servable, save_servable
    from distributed_tf_serving_tpu_torch.utils.config import MeshConfig, load_config

    t_phase = time.perf_counter()
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    cfgs = load_config(os.path.join(HERE, "configs", "latency.toml"))
    cfg, mc = cfgs["server"], cfgs["model"]
    F, V = mc.num_fields, mc.vocab_size
    res: dict = {"card": name, "steps": TRAINMESH_STEPS, "batch": TRAINMESH_BATCH, "runs": {}}
    tmp = tempfile.mkdtemp(prefix="dts_trainmesh_")
    server = batcher = None

    def save() -> None:
        with open(os.path.join(out_dir, "trainmesh.json"), "w") as f:
            json.dump(res, f, indent=1, default=str)

    def label(mesh_shape, tp) -> str:
        return "one_device" if mesh_shape is None else \
            f"{mesh_shape[0]}x{mesh_shape[1]}{'_tp' if tp else ''}"

    snapshot = None
    try:
        # 1. The runs: per-step losses, replicas, layouts, steps/s.
        for cdn in ("float32", "bfloat16"):
            model = build_model("dcn_v2", dataclasses.replace(
                mc, compute_dtype=cdn, use_pallas_cross=False))
            base_losses = None
            for mesh_shape, tp in TRAINMESH_RUNS:
                mesh = None
                if mesh_shape is not None:
                    d, m = mesh_shape
                    mesh = make_mesh(d * m, m, devices=[dev] * (d * m))
                tr = Trainer(model, mesh=mesh, tensor_parallel=tp, seed=SEED, device=dev)
                losses = []
                torch.cuda.synchronize()
                t0 = t1 = time.perf_counter()
                for i in range(TRAINMESH_STEPS):
                    _, met = tr.step_fn(tr.state, tr._prepare(
                        tr.stream.batch(TRAINMESH_BATCH, i)))
                    losses.append(met["loss"])
                    if i == 0:
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()  # the first step warms the path
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                losses = [float(v) for v in losses]
                if not all(math.isfinite(v) for v in losses):
                    fail(f"trainmesh: {cdn} {label(mesh_shape, tp)} lost finiteness: {losses}")
                run = {"losses": losses, "first_step_s": t1 - t0,
                       "steps_per_s": (TRAINMESH_STEPS - 1) / wall,
                       "examples_per_s": (TRAINMESH_STEPS - 1) * TRAINMESH_BATCH / wall}
                if mesh is None:
                    base_losses = losses
                else:
                    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
                    run["max_rel_loss_diff"] = rel
                    if rel > TRAINMESH_RTOL[cdn]:
                        fail(f"trainmesh: {cdn} {label(mesh_shape, tp)}: a step's loss is "
                             f"{rel:.3g} (relative) from the single-device run's (bound "
                             f"{TRAINMESH_RTOL[cdn]})")
                    unequal = [leaf.spec for leaf in placed_leaves(tr.state.params)
                               for group in leaf.replicas()
                               if any(not torch.equal(t, group[0]) for t in group[1:])]
                    if unequal:
                        fail(f"trainmesh: {cdn} {label(mesh_shape, tp)}: replicas differ "
                             f"after the last step ({unequal})")
                    run["replicas"] = sum(len(g) for leaf in placed_leaves(tr.state.params)
                                          for g in leaf.replicas())
                    specs = {"embedding": tr.state.params["embedding"].spec,
                             "mlp.0.w": tr.state.params["mlp"][0]["w"].spec}
                    want = P(None, MODEL_AXIS) if tp and mesh_shape[1] > 1 else P()
                    if specs["embedding"] != P(MODEL_AXIS, None) or specs["mlp.0.w"] != want:
                        fail(f"trainmesh: {label(mesh_shape, tp)} layout after the updates "
                             f"{specs}")
                    run["specs"] = {k: list(v) for k, v in specs.items()}
                    if cdn == "bfloat16" and mesh_shape == (2, 2) and tp:
                        snapshot = (model, tr.snapshot_params(), mesh)
                res["runs"][f"{cdn}/{label(mesh_shape, tp)}"] = run
                log(f"trainmesh ({name}): {cdn} {label(mesh_shape, tp)}: "
                    f"{run['steps_per_s']:.2f} steps/s, {run['examples_per_s']:.0f} ex/s, "
                    f"loss {losses[0]:.6f} -> {losses[-1]:.6f}"
                    + (f", max rel diff from one device {run['max_rel_loss_diff']:.3g}"
                       if mesh is not None else ""))
                del tr
                torch.cuda.empty_cache()
            save()

        # 2. The bf16 (2, 2) TP snapshot serves: a 1 x 1 [mesh] server over
        # gRPC, and (2, 2) ShardedExecutors over load_servable(mesh=), TP
        # off and on: the same bits.
        model, snap, mesh22 = snapshot
        ckpt = os.path.join(tmp, "trained")
        save_servable(ckpt, Servable(name="DCN", version=1, model=model,
                                     params=gather_params(snap), signatures=model_signatures(model)),
                      "dcn_v2")
        impl, batcher, _sv = build_stack(
            dataclasses.replace(cfg, warmup=False), mc, "cuda", checkpoint=ckpt,
            mesh_config=MeshConfig(enabled=True, devices=1), mesh_device_list=[dev])
        server, port = create_server(impl, "127.0.0.1:0")
        server.start()
        served = {}
        for n in TRAINMESH_SERVE:
            p = make_payload(n, F, seed=SEED + 11000 + n)
            with _channel(port) as ch:
                got = _scores_of(PredictionServiceStub(ch).Predict(
                    _request(p["feat_ids"], p["feat_wts"]), timeout=120))
            if got.shape != (n,) or not np.all(np.isfinite(got)):
                fail(f"trainmesh: the 1 x 1 server answered {got.shape} / non-finite scores")
            arrays = {"feat_ids": fold_ids_host(p["feat_ids"], V), "feat_wts": p["feat_wts"]}
            for tp in (False, True):
                sv22 = load_servable(ckpt, mesh=mesh22, tensor_parallel=tp)
                ex = ShardedExecutor(mesh22, tensor_parallel=tp)
                mine = ex(sv22, arrays, out_keys=("prediction_node",))["prediction_node"]
                mine = mine.float().cpu().numpy()
                if mine.tobytes() != got.tobytes():
                    fail(f"trainmesh: the (2, 2) executor{' with TP' if tp else ''} over "
                         f"load_servable(mesh=) at n = {n} is not the 1 x 1 server's bits "
                         f"(max diff {float(np.max(np.abs(mine - got))):.3g})")
            served[n] = True
        res["served_bits_equal"] = served
        log(f"trainmesh ({name}): the bf16 (2, 2) TP snapshot answered n = "
            f"{'/'.join(map(str, TRAINMESH_SERVE))} with the same bits through a 1 x 1 [mesh] "
            f"server and (2, 2) executors (TP off, on) over load_servable(mesh=)")
        server.stop(0)
        server = None
        batcher.stop()
        batcher = None
        save()

        # 3. The trainer CLI with --mesh-devices 1 writes a checkpoint the
        # port serves.
        cli_out = os.path.join(tmp, "cli")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", f"{PKG}.train.trainer", "--out", cli_out, "--steps",
             str(TRAINMESH_CLI_STEPS), "--batch-size", str(TRAINMESH_BATCH), "--num-fields",
             str(F), "--vocab-size", str(V), "--embed-dim", str(mc.embed_dim),
             "--mesh-devices", "1"],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        with open(os.path.join(out_dir, "trainmesh_cli.log"), "w") as f:
            f.write(run.stdout + run.stderr)
        m = re.search(r"trained dcn_v2 (\d+) steps on (\S+): loss=([\d.]+) auc=([\d.]+) "
                      r"bayes_auc=([\d.]+) \((\d+) ex/s\)", run.stdout)
        if run.returncode != 0 or m is None or not m.group(2).startswith("mesh"):
            fail(f"trainmesh: the trainer CLI (--mesh-devices 1) exited {run.returncode}: "
                 f"{(run.stdout + run.stderr)[-1500:]}")
        sv = load_servable(cli_out, device=dev)
        p = make_payload(7, F, seed=SEED + 12000)
        with torch.inference_mode():
            scores = sv.model.apply(sv.params, {
                "feat_ids": torch.from_numpy(fold_ids_host(p["feat_ids"], V)).to(dev),
                "feat_wts": torch.from_numpy(p["feat_wts"]).to(dev)})["prediction_node"]
        if scores.shape != (7,) or not torch.isfinite(scores).all():
            fail(f"trainmesh: the CLI's checkpoint scored {scores}")
        res["cli"] = {"where": m.group(2), "loss": float(m.group(3)), "auc": float(m.group(4)),
                      "examples_per_s": int(m.group(6)), "wall_s": cli_s}
        log(f"trainmesh ({name}): the trainer CLI --mesh-devices 1 ({TRAINMESH_CLI_STEPS} "
            f"steps x {TRAINMESH_BATCH}) on {m.group(2)}: loss {m.group(3)}, auc {m.group(4)}, "
            f"{m.group(6)} ex/s, {cli_s:.1f} s; its checkpoint serves")
    finally:
        if server is not None:
            server.stop(0)
        if batcher is not None:
            batcher.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    save()
    return res


def main(only: str | None = None) -> None:
    if not os.path.isdir(os.path.join(HERE, PKG)):
        fail(f"{PKG}/ not found beside chip_smoke.py")
    sys.path.insert(0, HERE)
    if os.path.exists(LOG_FILE):
        os.unlink(LOG_FILE)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {name} (torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]})")
    log(f"nvidia-smi: {smi}")

    from distributed_tf_serving_tpu_torch.ops import cuda_build, cross_kernel as ck

    import threading

    from distributed_tf_serving_tpu_torch import native

    t0 = time.perf_counter()
    built_native = {}

    def build_native():
        built_native["ok"] = native.ensure()
        built_native["s"] = time.perf_counter() - t0

    th = threading.Thread(target=build_native)
    th.start()  # g++ of the host ops beside nvcc of the kernels
    cuda_build.build_all()
    th.join(timeout=300)
    if not built_native.get("ok"):
        fail("the native host-ops library (native/hostops.cc) did not build with g++")
    log(f"build: {time.perf_counter() - t0:.2f} s (native host ops {built_native['s']:.2f} s)")
    registers = {src: check_build(src, info) for src, info in cuda_build.build_info.items()}
    if only == "fleet":
        fleet = phase_fleet(dev, f"{name} ({smi})")
        print(json.dumps({"edge_pause_s": FLEET_EDGE_PAUSE_S, "fleet": fleet}, default=str),
              flush=True)
        return
    if only == "mesh":
        mesh = phase_mesh(dev, f"{name} ({smi})")
        log(f"mesh: phase {mesh['phase_s']:.1f} s")
        print(json.dumps({"mesh": mesh}, default=str), flush=True)
        return
    if only == "trainmesh":
        trainmesh = phase_trainmesh(dev, f"{name} ({smi})")
        log(f"trainmesh: phase {trainmesh['phase_s']:.1f} s")
        print(json.dumps({"trainmesh": trainmesh}, default=str), flush=True)
        return

    t0 = time.perf_counter()
    rows = phase_kernels(dev, registers[ck.SOURCE])
    log(f"kernels: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serving = phase_serving(dev, f"{name} ({smi})")
    log(f"serving: phase {time.perf_counter() - t0:.1f} s")
    # The card's own per-bucket device step, for the utilization phase's
    # calibration: the breakdown's synchronized device step (launch and
    # kernel, the card idle before it), median of 20, in us.
    step_table = os.path.join(HERE, "chiprun_out", "device_step_us.json")
    with open(step_table, "w") as f:
        json.dump({str(b): v["device_step"] * 1e3
                   for b, v in serving["breakdown"]["stages_ms"].items()}, f)
    log(f"device step table (breakdown device_step, us): {open(step_table).read()}")
    t0 = time.perf_counter()
    lifecycle = phase_lifecycle(dev, f"{name} ({smi})")
    log(f"lifecycle: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    outputs = phase_outputs(dev, f"{name} ({smi})")
    log(f"outputs: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    families = phase_families(dev, f"{name} ({smi})")
    log(f"families: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    models = phase_models(dev, f"{name} ({smi})")
    log(f"models: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rest = phase_rest(dev, f"{name} ({smi})")
    log(f"rest: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    aio = phase_aio(dev, f"{name} ({smi})")
    log(f"aio: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cache = phase_cache(dev, f"{name} ({smi})")
    log(f"cache: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    integrity = phase_integrity(dev, f"{name} ({smi})")
    log(f"integrity: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    overload = phase_overload(dev, f"{name} ({smi})")
    log(f"overload: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cascade = phase_cascade(dev, f"{name} ({smi})")
    log(f"cascade: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    utilization = phase_utilization(dev, f"{name} ({smi})", step_table)
    log(f"utilization: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    freshness = phase_freshness(dev, f"{name} ({smi})")
    log(f"freshness: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    recovery = phase_recovery(dev, f"{name} ({smi})")
    log(f"recovery: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    savedmodel = phase_savedmodel(dev, f"{name} ({smi})")
    log(f"savedmodel: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fleet = phase_fleet(dev, f"{name} ({smi})")
    log(f"fleet: phase {time.perf_counter() - t0:.1f} s")
    mesh = phase_mesh(dev, f"{name} ({smi})")
    log(f"mesh: phase {mesh['phase_s']:.1f} s")
    trainmesh = phase_trainmesh(dev, f"{name} ({smi})")
    log(f"trainmesh: phase {trainmesh['phase_s']:.1f} s")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "registers": registers, "kernels": rows, "serving": serving,
                   "lifecycle": lifecycle, "outputs": outputs, "families": families,
                   "models": models, "rest": rest, "aio": aio, "cache": cache,
                   "integrity": integrity, "overload": overload, "cascade": cascade,
                   "utilization": utilization, "freshness": freshness,
                   "recovery": recovery, "savedmodel": savedmodel, "fleet": fleet,
                   "mesh": mesh, "trainmesh": trainmesh}, f,
                  indent=1,
                  default=str)

    replaces = {
        "fused_serve": "distributed_tf_serving_tpu/ops/cross_kernel.py:470",
        "fused_serve_int8": "distributed_tf_serving_tpu/ops/cross_kernel.py:470 (int8 operands)",
        "fused_cross_apply": "distributed_tf_serving_tpu/ops/cross_kernel.py:114",
    }
    kernels = []
    for cd in ("bfloat16", "float32"):
        for kname, line in replaces.items():
            # The rule's row at 2048 rows in this compute dtype.
            head = next(r for r in rows[kname]
                        if r["dtype"] == cd and r["n"] == 2048 and not r.get("forced"))
            # `launches`: the serving path's count plus the outputs path's,
            # each zeroed just before its run and read just after it.
            entry = {"name": kname if cd == "bfloat16" else f"{kname}_f32", "route": "cuda",
                     "source": f"{PKG}/csrc/cross_kernel.cu", "replaces": line,
                     "launches": serving["launches"][f"{kname}/{cd}"]
                     + outputs["launches"].get(f"{kname}/{cd}", 0),
                     "launches_serving": serving["launches"][f"{kname}/{cd}"],
                     "launches_outputs": outputs["launches"].get(f"{kname}/{cd}", 0),
                     "launches_lifecycle": lifecycle["launches"]["path"].get(f"{kname}/{cd}", 0),
                     # The models server's count, from its start to its exit.
                     "launches_models": models["launches"].get(f"{kname}/{cd}", 0),
                     # The REST path in this process (zeroed just before its
                     # requests, read just after), and the REST CLI server's
                     # count from its start to its exit.
                     "launches_rest": rest["path"]["launches"].get(f"{kname}/{cd}", 0),
                     "launches_rest_server": rest["launches_server"].get(f"{kname}/{cd}", 0),
                     # The aio path: the plane stack's requests (zeroed just
                     # before, read just after) and the breaker stack's (its
                     # counts before subtracted).
                     "launches_aio": (aio["serving"]["launches"].get(f"{kname}/{cd}", 0)
                                      + aio["breaker"]["launches"].get(f"{kname}/{cd}", 0)),
                     # The cache phase's steps 1-4 (zeroed just before, read
                     # just after).
                     "launches_cache": cache["launches"].get(f"{kname}/{cd}", 0),
                     # The integrity phase's shadowed run (each batch and its
                     # shadow; the plane-off references before it counted
                     # apart), and the overload phase's armed load runs.
                     "launches_integrity": integrity["launches"].get(f"{kname}/{cd}", 0),
                     "launches_overload": overload["launches"].get(f"{kname}/{cd}", 0),
                     # The cascade phase's eligible Predicts (its plane-off
                     # references counted apart).
                     "launches_cascade": cascade["launches"].get(f"{kname}/{cd}", 0),
                     # The utilization phase's two plane-on loop runs (in
                     # process, zeroed just before, read just after).
                     "launches_utilization": utilization["launches"].get(f"{kname}/{cd}", 0),
                     # The freshness phase's two CLI servers (the publishing
                     # and the rollback run), each from its start to its exit.
                     "launches_freshness": freshness["launches"].get(f"{kname}/{cd}", 0),
                     # The recovery phase's two CLI servers (the transient,
                     # the bisection, the wedge and the SIGTERM during a
                     # cycle), each from its start to its exit.
                     "launches_recovery": recovery["launches"].get(f"{kname}/{cd}", 0),
                     # The savedmodel phase's import server over its
                     # Predicts (its count at shutdown less its count when
                     # it was ready), and its base-path server from v1's
                     # load to its exit (v2 imported and swapped in).
                     "launches_savedmodel": savedmodel["launches"].get(f"{kname}/{cd}", 0),
                     "launches_savedmodel_base":
                         savedmodel["launches_base"].get(f"{kname}/{cd}", 0),
                     # The fleet phase's three replicas' served launches,
                     # each from v1 ready to its exit less every version's
                     # warmup (the SIGKILLed process's count is lost; its
                     # restart's is in).
                     "launches_fleet": fleet["launches"].get(f"{kname}/{cd}", 0),
                     # The mesh phase's main paths: the [mesh] CLI server's
                     # served launches, the logical meshes' executor calls,
                     # the elastic stack under load and the multi-process
                     # servers' served launches (each zeroed or differenced
                     # around its run).
                     "launches_mesh": mesh["launches"].get(f"{kname}/{cd}", 0),
                     "library_ms": None,
                     "shape": f"{'bf16' if cd == 'bfloat16' else 'f32'}, 2048 rows"}
            entry.update((k, head[k]) for k in (
                "max_abs_err", "ms", "plain_ms", "loop_ms", "plain_loop_ms", "device_ms",
                "bound_ms", "bound_by", "rows_per_block", "cluster", "registers",
                "spill_bytes") if k in head)
            entry["by_shape"] = [r for r in rows[kname] if r["dtype"] == cd]
            kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--recovery-child":
        _recovery_child(sys.argv[2])  # the recovery phase's sticky-error child
    elif len(sys.argv) == 4 and sys.argv[1] == "--graph-calls":
        _graph_calls_child(sys.argv[2], sys.argv[3])  # the savedmodel phase's timing child
    else:
        main(only={"--fleet-only": "fleet", "--mesh-only": "mesh",
                   "--trainmesh-only": "trainmesh"}.get(" ".join(sys.argv[1:])))
