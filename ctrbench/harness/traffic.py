"""One general generator of CTR Predict traffic, driven by a traffic file.

A traffic file (`ctrbench/workloads/<traffic>.json`) holds parameters only:

- `loop`: "closed" (`clients` callers, each sending its next request when
  the last one answered) or "open" (Poisson arrivals at `rate_per_s`, sent
  by `senders` threads whether or not earlier requests have answered).
- `candidates`: {"dist": "fixed", "n": N} or {"dist": "uniform", "low": A,
  "high": B} (inclusive), the candidate count of one request.
- `ids`: {"dist": "uniform", "low": 0, "high": H}: raw int64 feature ids,
  folded into the vocabulary by the server.
- `weights`: {"dist": "uniform"} (in [0, 1)) or {"dist": "one"}.
- `dense`: for models with dense features, {"dist": "log1p_lognormal",
  "mu": M, "sigma": S}: log1p of heavy-tailed counts floor(exp(N(M, S))).
- `traffic_seed`: the seed of the fixed multiset of sizes and gaps. Every
  run seed gets the same multiset in another order, so seeds change the
  order and the content of the work, never its amount.
- `sample_requests`: how many answered requests the comparison checks.

The content of request k of stream s comes from
`np.random.default_rng([seed, s, k])`, so the parent process regenerates
exactly what a load-generator process sent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Sizes drawn per cycle of a closed-loop stream; a stream that sends more
# requests than this walks the same permuted table again.
SIZE_TABLE = 4096


def _seed_words(seed: int) -> list[int]:
    seed = int(seed) % (1 << 64)
    return [seed & 0xFFFFFFFF, seed >> 32]


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    spec: dict

    @property
    def loop(self) -> str:
        return self.spec["loop"]

    def size_range(self) -> tuple[int, int]:
        c = self.spec["candidates"]
        if c["dist"] == "fixed":
            return int(c["n"]), int(c["n"])
        return int(c["low"]), int(c["high"])

    def _draw_sizes(self, rng: np.random.Generator, count: int) -> np.ndarray:
        c = self.spec["candidates"]
        if c["dist"] == "fixed":
            return np.full(count, int(c["n"]), np.int64)
        if c["dist"] == "uniform":
            return rng.integers(int(c["low"]), int(c["high"]) + 1, size=count, dtype=np.int64)
        raise ValueError(f"unknown candidate distribution {c['dist']!r}")

    def stream_sizes(self, seed: int, stream: int) -> np.ndarray:
        """The size table of one closed-loop stream: a fixed multiset,
        permuted by the run seed."""
        base = np.random.default_rng([int(self.spec.get("traffic_seed", 0)), stream])
        table = self._draw_sizes(base, SIZE_TABLE)
        perm = np.random.default_rng([*_seed_words(seed), stream, 1 << 20]).permutation(SIZE_TABLE)
        return table[perm]

    def schedule(self, seed: int, seconds: float) -> tuple[np.ndarray, np.ndarray]:
        """(due offsets in seconds from the window's start, sizes) of every
        open-loop arrival in the window: round(rate_per_s * seconds)
        Poisson arrivals (exponential gaps scaled to fill the window, the
        arrival process given its count) and their sizes, each a fixed
        multiset permuted by the run seed, so every seed offers the same
        work."""
        rate = float(self.spec["rate_per_s"])
        count = max(int(round(rate * seconds)), 1)
        base = np.random.default_rng([int(self.spec.get("traffic_seed", 0)), 7])
        gaps = base.exponential(1.0, size=count + 1)
        sizes = self._draw_sizes(base, count)
        run = np.random.default_rng([*_seed_words(seed), 7])
        gaps = gaps[run.permutation(count + 1)]
        due = np.cumsum(gaps)[:-1] / gaps.sum() * seconds
        return due, sizes[run.permutation(count)]

    def request(self, seed: int, stream: int, k: int, n: int, num_fields: int,
                num_dense: int = 0) -> dict[str, np.ndarray]:
        """Inputs of request k of `stream`, with n candidates."""
        rng = np.random.default_rng([*_seed_words(seed), stream, k])
        ids_spec = self.spec["ids"]
        ids = rng.integers(int(ids_spec.get("low", 0)), int(ids_spec["high"]),
                           size=(n, num_fields), dtype=np.int64)
        w = self.spec["weights"]["dist"]
        if w == "uniform":
            wts = rng.random((n, num_fields), dtype=np.float32)
        elif w == "one":
            wts = np.ones((n, num_fields), np.float32)
        else:
            raise ValueError(f"unknown weight distribution {w!r}")
        out = {"feat_ids": ids, "feat_wts": wts}
        if num_dense:
            d = self.spec["dense"]
            if d["dist"] != "log1p_lognormal":
                raise ValueError(f"unknown dense distribution {d['dist']!r}")
            counts = np.floor(np.exp(rng.normal(float(d["mu"]), float(d["sigma"]),
                                                size=(n, num_dense))))
            out["dense_features"] = np.log1p(counts).astype(np.float32)
        return out


def reachable_buckets(traffic: Traffic, buckets: tuple[int, ...]) -> tuple[int, ...]:
    """The server buckets this traffic can fill: a request alone, or
    requests coalesced up to the largest bucket. Only these are warmed."""
    ladder = sorted(buckets)
    low, high = traffic.size_range()
    top = ladder[-1]
    if high > top:
        raise ValueError(f"{traffic.name}: requests of {high} candidates exceed bucket {top}")
    most = top if 2 * low <= top else high
    return tuple(b for i, b in enumerate(ladder)
                 if b >= low and (i == 0 or ladder[i - 1] < most))
