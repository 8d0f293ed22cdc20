"""One serving replica of the program under test, in this process: the
port's own `build_stack` and threaded `create_server` (as `serve()` starts
them), serving weights the benchmark made on the card from the seed.

`build_stack` always loads a servable of its own (the numpy-seeded demo
weights, made on the host). It is built here at a vocabulary of one row,
which costs nothing, and replaced before any request by the benchmark's
servable, handed in through the public API (`Servable`,
`ServableRegistry.load`) and warmed through the batcher's queue over the
buckets this cell's traffic reaches.
"""

from __future__ import annotations

import dataclasses
import gc

import torch

from . import spec as spec_mod
from .traffic import Traffic, reachable_buckets


def model_config(config: dict, vocab_size: int | None = None):
    from distributed_tf_serving_tpu_torch.models.base import ModelConfig

    model = dict(config["model"])
    if vocab_size is not None:
        model["vocab_size"] = vocab_size
    for key in ("mlp_dims", "bottom_mlp_dims"):
        if key in model:
            model[key] = tuple(model[key])
    return ModelConfig(**model)


def server_config(config: dict):
    from distributed_tf_serving_tpu_torch.utils.config import ServerConfig

    server = dict(config["server"])
    server["buckets"] = tuple(server["buckets"])
    return ServerConfig(model_kind=config["kind"], model_name=config["model"]["name"],
                        num_fields=config["model"]["num_fields"], host="127.0.0.1", port=0,
                        warmup=False, **server)


class Replica:
    """build_stack + the benchmark's servable + a started gRPC server."""

    def __init__(self, config: dict, traffic: Traffic, seed: int, device,
                 timings: dict | None = None):
        import time

        from distributed_tf_serving_tpu_torch.models import build_model
        from distributed_tf_serving_tpu_torch.models.registry import Servable, model_signatures
        from distributed_tf_serving_tpu_torch.serving.server import build_stack, create_server

        timings = timings if timings is not None else {}
        self.config = config
        self.device = torch.device(device)
        cfg = server_config(config)
        t0 = time.perf_counter()
        self.impl, self.batcher, demo = build_stack(cfg, model_config(config, vocab_size=1),
                                                    device=self.device)
        timings["build_stack_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = spec_mod.reference(config["kind"])
        params = ref.make_params(config["model"], seed, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timings["weights_s"] = time.perf_counter() - t0
        model = build_model(config["kind"], model_config(config))
        self.servable = Servable(name=demo.name, version=demo.version + 1, model=model,
                                 params=params, signatures=model_signatures(model))
        self.impl.registry.load(self.servable)
        self.impl.registry.unload(demo.name, demo.version)
        del demo
        t0 = time.perf_counter()
        self.buckets = reachable_buckets(traffic, cfg.buckets)
        self.batcher.warmup_via_queue(self.servable, self.buckets)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timings["warmup_s"] = time.perf_counter() - t0
        self.server, self.port = create_server(self.impl, "127.0.0.1:0", cfg.max_workers)
        self.server.start()
        self.address = f"127.0.0.1:{self.port}"

    def snapshot(self) -> dict:
        """The program's own spans and counters now: the aggregate phases
        (the `/monitoring` `phases` block) and BatcherStats."""
        from distributed_tf_serving_tpu_torch.utils.tracing import request_trace

        with self.batcher._stats_lock:
            stats = dataclasses.asdict(self.batcher.stats)
        return {"phases": request_trace.snapshot(), "stats": stats}

    def stop(self) -> None:
        """Stop the server and the batcher and free the program's state."""
        self.server.stop(grace=5.0).wait(10.0)
        self.batcher.stop()
        self.impl.registry.unload(self.servable.name)
        self.servable = self.impl = self.batcher = self.server = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def delta_sum(befores: list[dict], afters: list[dict]) -> dict:
    """delta() over several replicas, phases and counters summed."""
    out = {"phases": {}, "stats": {}}
    for b, a in zip(befores, afters):
        d = delta(b, a)
        for name, p in d["phases"].items():
            q = out["phases"].setdefault(name, {"seconds": 0.0, "count": 0})
            q["seconds"] += p["seconds"]
            q["count"] += p["count"]
        for k, v in d["stats"].items():
            out["stats"][k] = out["stats"].get(k, 0) + v
    return out


def delta(before: dict, after: dict) -> dict:
    """What the window added: per phase (seconds, count), per counter the
    difference."""
    phases = {}
    for name, p in after["phases"].items():
        b = before["phases"].get(name, {"total_ms": 0.0, "count": 0})
        count = p["count"] - b["count"]
        if count > 0:
            phases[name] = {"seconds": (p["total_ms"] - b["total_ms"]) / 1e3, "count": count}
    stats = {k: v - before["stats"].get(k, 0) for k, v in after["stats"].items()
             if isinstance(v, (int, float))}
    return {"phases": phases, "stats": stats}
