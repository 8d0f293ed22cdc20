"""Replicas in processes of their own, one per card, for cells that fan out
over several cards: each process builds one `replica.Replica` on its card
and answers the coordinator's commands over a Pipe.

Commands: "snapshot" -> the program's phases and counters; ("trace", at,
length) -> profile `length` seconds starting `at` seconds from now, on the
process's main thread (no answer); "collect" -> (the slice's reduction,
the timeline, the card's memory peak); "stop" -> free the replica and end.
"""

from __future__ import annotations

import time

from . import child, imports


def replica_main(conn, config: dict, traffic_spec: dict, traffic_name: str, seed: int,
                 trace: bool, device: str) -> None:
    import torch

    from . import devtrace, replica
    from .traffic import Traffic

    rep = replica.Replica(config, Traffic(traffic_name, traffic_spec), seed, device)
    if trace:
        devtrace.prime()
    conn.send(("ready", rep.address))
    traced = None
    try:
        while True:
            cmd = conn.recv()
            if cmd == "snapshot":
                conn.send(rep.snapshot())
            elif isinstance(cmd, tuple) and cmd[0] == "trace":
                rep.batcher.timeline = []
                time.sleep(cmd[1])
                traced = devtrace.profile_slice(cmd[2], lambda: rep.snapshot()["stats"])
            elif cmd == "collect":
                reduced = why = timeline = None
                if traced is not None:
                    reduced, why = traced
                    timeline = rep.batcher.timeline
                    rep.batcher.timeline = None
                peak = (int(torch.cuda.max_memory_allocated(rep.device))
                        if rep.device.type == "cuda" else 0)
                conn.send({"trace": reduced, "trace_error": why,
                           "timeline": timeline, "peak": peak,
                           "forbidden": imports.forbidden_loaded()})
            elif cmd == "stop":
                return
    finally:
        rep.stop()
        conn.close()


class ReplicaSet:
    """One replica process per card: cuda:0 .. cuda:n-1 (or `device` for
    every one of them, in the CPU tests)."""

    def __init__(self, n: int, config: dict, traffic, seed: int, trace: bool,
                 device: str | None = None):
        self.conns = []
        self.procs = []
        for i in range(n):
            p, conn = child.start("ctrbench.harness.replicas", "replica_main",
                                  (config, traffic.spec, traffic.name, seed, trace,
                                   device or f"cuda:{i}"), f"ctrbench-replica-{i}")
            self.conns.append(conn)
            self.procs.append(p)
        self.addresses = []
        for conn, p in zip(self.conns, self.procs):
            if not conn.poll(600.0):
                raise RuntimeError(f"replica {p.name} did not come up (exit code {p.exitcode})")
            kind, address = conn.recv()
            self.addresses.append(address)

    def ask(self, cmd) -> list:
        for c in self.conns:
            c.send(cmd)
        return [c.recv() for c in self.conns]

    def tell(self, cmd) -> None:
        for c in self.conns:
            c.send(cmd)

    def stop(self) -> None:
        for c, p in zip(self.conns, self.procs):
            try:
                c.send("stop")
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(60.0)
            if p.is_alive():
                p.terminate()
                p.join(10.0)

