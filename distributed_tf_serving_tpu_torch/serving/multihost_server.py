"""Multi-process serving entry point: one logical model over a process
group (parallel/multihost.py). Every process runs

    python -m distributed_tf_serving_tpu_torch.serving.multihost_server \\
        --model-base-path /shared/models/DCN \\
        --coordinator HOST0:7777 --num-processes K --process-id k [--port 9999] \\
        [--device cuda|cpu]

Process 0 serves gRPC (and with --rest-port the REST gateway) and leads;
the rest follow. Versions live in the TF-Serving base-path convention on
SHARED storage (every process sees the same directory): the leader's
VersionWatcher drives group-wide RELOAD hot-swaps, and followers load each
version through the same path. The backend is NCCL where every process has
a card of its own, gloo otherwise (multihost.pick_backend). A dead process
fails the whole group fast: the leader's heartbeat or its next collective
fails within the group's timeout (HEARTBEAT_TIMEOUT_S), and the leader then
exits nonzero; restart the job, as with any SPMD deployment. SIGTERM or
SIGINT on the leader stops the watcher, the server and the batcher, then
releases the followers (SHUTDOWN) and exits 0.

Split from serving/server.py so single-process serving never imports the
torch.distributed machinery.
"""

from __future__ import annotations

import logging
import os
import signal
import threading

import numpy as np

log = logging.getLogger("dts_torch.multihost_server")

# Dead-process detection in seconds: the process group's timeout, and twice
# the leader's heartbeat interval.
HEARTBEAT_TIMEOUT_S = 10


def build_multihost_stack(
    base_path,
    coordinator: str | None,
    num_processes: int,
    process_id: int,
    model_kind: str = "dcn_v2",
    model_name: str = "DCN",
    buckets: tuple[int, ...] = (1024, 8192),
    model_parallel: int = 1,
    max_wait_us: int = 2000,
    poll_interval_s: float = 5.0,
    max_load_attempts: int = 3,
    device=None,
):
    """Join the process group and build the serving stack.

    Returns (runner, registry, batcher, impl, watcher) on process 0 and
    (runner, None, None, None, None) on followers — the caller runs
    `runner.follow()` there. The initial version is chosen by the LEADER
    and broadcast, so processes scanning shared storage at different
    moments cannot disagree about the starting params.

    The architecture comes from the checkpoint's manifest, never from
    flags, and the batch templates from the servable's own signature (so
    DLRM's dense_features crosses the broadcast). `model_kind` only
    parameterizes the watcher's SavedModel-dir handling. `device` is where
    every process scores: "cuda" (default; card rank % cards) or "cpu"."""
    import dataclasses as dc

    from ..models import ServableRegistry
    from ..parallel.multihost import (
        MultiHostRunner,
        broadcast_int,
        global_mesh,
        init_distributed,
    )
    from ..train.checkpoint import load_servable
    from .batcher import DynamicBatcher
    from .service import PredictionServiceImpl
    from .version_watcher import VersionWatcher, VersionWatcherConfig, scan_versions

    backend = init_distributed(coordinator, num_processes, process_id,
                               heartbeat_timeout_s=HEARTBEAT_TIMEOUT_S)
    mesh = global_mesh(model_parallel=model_parallel, device=device)
    log.info("process %d/%d joined (%s), mesh %s", process_id, num_processes, backend, mesh)

    # The leader picks the starting version; everyone loads that one.
    local_latest = max(scan_versions(base_path), default=0) if process_id == 0 else 0
    initial = broadcast_int(local_latest) if num_processes > 1 else local_latest
    if initial == 0:
        raise FileNotFoundError(f"no version directories under {base_path}")

    def load_version(version: int):
        # A host load on every process; the runner moves the params to its
        # device at a protocol-aligned point (construction, or the RELOAD
        # header).
        return load_servable(f"{base_path}/{version}", device="cpu")

    def filter_signatures(sv, version):
        # The broadcast protocol gathers ONE output tensor (the scores); the
        # registered signature must promise exactly what the runner serves,
        # or a Predict without an output_filter would fail INTERNAL.
        signatures = {
            name: dc.replace(
                sig,
                outputs=tuple(s for s in sig.outputs if s.name == "prediction_node"),
            )
            for name, sig in sv.signatures.items()
        }
        return dc.replace(sv, version=version, name=model_name, signatures=signatures)

    initial_sv = filter_signatures(load_version(initial), initial)
    model = initial_sv.model

    # Templates from the servable's OWN signature: every declared input
    # crosses the broadcast (feat_ids as folded int32; the rest — feat_wts,
    # DLRM dense_features — as float32 with their trailing dims).
    sig = initial_sv.signature("")

    def template(b: int) -> dict[str, np.ndarray]:
        out = {}
        for spec in sig.inputs:
            trailing = tuple(d or 1 for d in (spec.shape or (None, 1))[1:])
            dtype = np.int32 if spec.name == "feat_ids" else np.float32
            out[spec.name] = np.zeros((b, *trailing), dtype)
        return out

    runner = MultiHostRunner(
        mesh=mesh,
        params=initial_sv.params,
        score_fn=lambda p, b: model.apply(p, b)["prediction_node"],
        batch_templates=[template(b) for b in sorted(buckets)],
        param_loader=lambda version: load_version(version).params,
    )
    runner.version = initial
    if process_id != 0:
        return runner, None, None, None, None

    registry = ServableRegistry()
    # Pre-seeded: the watcher's first poll must not reload and re-broadcast
    # what every process just loaded.
    registry.load(initial_sv)
    batcher = DynamicBatcher(
        buckets=runner.buckets, max_wait_us=max_wait_us, device=runner.device,
        run_fn=runner.as_run_fn(),
    ).start()
    impl = PredictionServiceImpl(registry, batcher)
    # A label-only reload may re-state this source verbatim; without the
    # entry the reload gate would read it as a base-path move.
    impl.served_sources[model_name] = (str(base_path), model_kind)

    watcher = VersionWatcher(
        base_path,
        registry,
        VersionWatcherConfig(
            poll_interval_s=poll_interval_s,
            model_name=model_name,
            model_kind=model_kind,
            max_load_attempts=max_load_attempts,
        ),
        loader=runner.watcher_loader(
            lambda version, path: filter_signatures(load_servable(path, device="cpu"), version)
        ),
    ).start()
    return runner, registry, batcher, impl, watcher


def serve(argv=None) -> None:
    import argparse

    from .server import _launch_counts, create_server, load_ssl_credentials, start_rest_in_thread

    parser = argparse.ArgumentParser(description="Multi-process PredictionService")
    parser.add_argument("--model-base-path", required=True)
    parser.add_argument("--coordinator", help="process 0's host:port (torch.distributed)")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("--port", type=int, default=9999)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--model-kind", default="dcn_v2",
                        help="only for SavedModel version dirs; native checkpoints "
                        "carry their architecture in the manifest")
    parser.add_argument("--model-name", default="DCN")
    parser.add_argument("--buckets", default="1024,8192",
                        help="comma-separated multi-process bucket ladder")
    parser.add_argument("--model-parallel", type=int, default=1)
    parser.add_argument("--max-workers", type=int, default=32)
    parser.add_argument("--rest-port", type=int, default=0,
                        help="the leader also serves the TF-Serving REST API on this port")
    parser.add_argument("--ssl-config-file", dest="ssl_config_file",
                        help="secure the leader's gRPC port (SSLConfig textproto, the "
                        "single-process CLI's format)")
    parser.add_argument("--file-system-poll-wait-seconds", dest="file_system_poll_wait_seconds",
                        type=float, default=5.0,
                        help="version-watcher poll interval (upstream flag name)")
    parser.add_argument("--max-num-load-retries", dest="max_num_load_retries", type=int,
                        default=2, help="retries AFTER the first load attempt (upstream "
                        "flag semantics)")
    args = parser.parse_args(argv)
    # Fail fast like the single-process CLI: validate before joining.
    credentials = load_ssl_credentials(args.ssl_config_file) if args.ssl_config_file else None

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    runner, registry, batcher, impl, watcher = build_multihost_stack(
        args.model_base_path,
        args.coordinator,
        args.num_processes,
        args.process_id,
        model_kind=args.model_kind,
        model_name=args.model_name,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        model_parallel=args.model_parallel,
        poll_interval_s=args.file_system_poll_wait_seconds,
        max_load_attempts=args.max_num_load_retries + 1,  # upstream: retries
        device=args.device,
    )
    if args.process_id != 0:
        log.info("follower %d/%d up (mesh %s); serving until leader shutdown",
                 args.process_id, args.num_processes, runner.mesh.shape)
        runner.follow()
        log.info("follower %d released; kernel launches at shutdown: %s", args.process_id,
                 _launch_counts())
        return

    from ..utils.metrics import ServerMetrics

    # One metrics instance across gRPC and REST.
    metrics = ServerMetrics()
    server, port = create_server(impl, f"{args.host}:{args.port}", args.max_workers,
                                 credentials=credentials, metrics=metrics)
    server.start()

    def teardown() -> None:
        # Watcher first, so no RELOAD broadcast interleaves with the group's
        # shutdown.
        watcher.stop()
        server.stop(2).wait()
        batcher.stop()

    if args.rest_port:
        try:
            bound = start_rest_in_thread(impl, args.host, args.rest_port, metrics)
        except RuntimeError as exc:
            teardown()
            runner.shutdown()
            raise SystemExit(str(exc)) from exc
        log.info("REST gateway on %s:%d (/v1/models/...)", args.host, bound)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    runner.start_heartbeat(HEARTBEAT_TIMEOUT_S / 2)
    # The warmup-free start's launches: a request path's are the difference
    # to the count at shutdown.
    log.info("kernel launches at start: %s", _launch_counts())
    log.info("multihost PredictionService on %s:%d (mesh %s, version %s, device %s)",
             args.host, port, runner.mesh.shape, runner.version, runner.device)
    while not stop.is_set() and not runner.failed.is_set():
        stop.wait(0.2)
    if runner.failed.is_set():
        # A peer is gone: the group cannot serve. Exit nonzero without the
        # interpreter's teardown, which would wait on the broken group.
        log.error("multihost group failed: %r; exiting", runner.failure)
        watcher.stop()
        server.stop(0)
        logging.shutdown()
        os._exit(1)
    teardown()
    runner.shutdown()
    log.info("released the followers; kernel launches at shutdown: %s", _launch_counts())


if __name__ == "__main__":
    serve()
