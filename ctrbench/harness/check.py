"""The comparison that decides `correct`.

Once the window has closed and the program's state is freed, the plain
reference recomputes, in float32, every candidate of a seeded sample of the
answered requests (with the longest request in it): the weights anew from
the seed, each request's inputs anew from the seed, in blocks of rows. The
number compared is the widest gap between a served score and the
reference's score of the same candidate, held to the configuration's limit
(`check.score_max_abs_err` in its file). Every answer of the window is also
checked for its shape and for finite scores by the load generator (a
malformed or missing answer is a failure), and failures are held to 0. An
empty sample compares as an infinite gap.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spec as spec_mod
from .traffic import Traffic

BLOCK_ROWS = 16384


def reference_scores(config: dict, traffic: Traffic, seed: int, sample: list, device,
                     precision: str = "float32") -> list[np.ndarray]:
    """The reference's scores of each sampled request (stream, k, n, _)."""
    ref = spec_mod.reference(config["kind"])
    model = config["model"]
    params = ref.make_params(model, seed, device)
    out = []
    dense = model.get("num_dense_features", 0) if config["kind"] == "dlrm" else 0
    with torch.inference_mode():
        for stream, k, n, _ in sample:
            inputs = traffic.request(seed, stream, k, n, model["num_fields"], dense)
            scores = []
            for lo in range(0, n, BLOCK_ROWS):
                block = {key: torch.from_numpy(v[lo:lo + BLOCK_ROWS]).to(device)
                         for key, v in inputs.items()}
                scores.append(ref.forward(params, block, model, precision).float().cpu().numpy())
            out.append(np.concatenate(scores))
    return out


def score_gap(served: list[np.ndarray], reference: list[np.ndarray]) -> float:
    """max |served - reference| over every sampled candidate."""
    return max(float(np.max(np.abs(s.astype(np.float64) - r.astype(np.float64))))
               for s, r in zip(served, reference))


def compare(config: dict, traffic: Traffic, seed: int, load: dict, device) -> dict:
    """{name: {"value", "limit"}} of every number compared, and `correct`."""
    sample = load["sample"]
    limit = float(config["check"]["score_max_abs_err"])
    numbers = {"failed": {"value": int(load["failed"]), "limit": 0}}
    if sample:
        ref = reference_scores(config, traffic, seed, sample, device)
        gap = score_gap([s for *_, s in sample], ref)
    else:
        gap = float("inf")
    numbers["score_max_abs_err"] = {"value": gap, "limit": limit}
    correct = numbers["failed"]["value"] == 0 and gap <= limit
    return {"correct": bool(correct), "numbers": numbers}
