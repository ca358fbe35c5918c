"""The one generator of traffic: every mix is a JSON file under
``traffic/`` that sets its parameters.

A request is a user's history of item ids with a k.  Lengths are drawn
from a log-normal (``length``: median, sigma, clipped to [min, max]) and
ids from a Zipf law over the catalogue (``items``: exponent; rank r is
item id r, for r = 1 .. N).  Request i is the same for a seed whatever
the rate at which it is used: requests are made in chunks of ``CHUNK``,
chunk j from its own stream of the seed, on the run's device.

``max_batch`` is the most requests the engine serves in one batch.
``loop`` says how requests are offered:

* ``closed``: a backlog.  ``waiting`` requests are kept submitted and
  unanswered all through the window; ``pregen_req_per_s`` times the
  window's seconds are made before the window opens.
* ``open``: Poisson arrivals at ``load`` times ``knee_req_per_s`` (the
  highest rate the cell sustains, found by ``sweep.py``), each request
  timed from when it was due.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from portbench import seeds

CHUNK = 16_384
ARRIVAL_BLOCK = 65_536
LOOPS = ("closed", "open")


def load(traffic_dir: Path, name: str) -> Dict[str, Any]:
    """The mix ``name``: ``traffic/<name>.json``."""
    path = Path(traffic_dir) / f"{name}.json"
    spec = json.loads(path.read_text())
    if spec.get("loop") not in LOOPS:
        raise ValueError(f"{path}: loop must be one of {LOOPS}")
    return spec


def rate_per_s(spec: Dict[str, Any]) -> float:
    """An open mix's offered rate: its load times the cell's knee."""
    return float(spec["knee_req_per_s"]) * float(spec["load"])


def zipf_cdf(n_items: int, exponent: float, device) -> torch.Tensor:
    """Cumulative weights r^-exponent of ranks 1..n_items, float64."""
    r = torch.arange(1, n_items + 1, dtype=torch.float64, device=device)
    return torch.cumsum(r.pow(-float(exponent)), 0)


class Histories:
    """Request histories of one mix, catalogue and seed, made chunk by
    chunk: ``get(i)`` is request i's history (an int32 numpy view)."""

    def __init__(self, spec: Dict[str, Any], n_items: int, seed: int,
                 device, stream: int = seeds.HISTORIES):
        self.length = spec["length"]
        items = spec["items"]
        if self.length.get("dist") != "lognormal" or \
                items.get("dist") != "zipf":
            raise ValueError("lengths are drawn log-normal and ids Zipf")
        self.n_items = n_items
        self.seed, self.stream = seed, stream
        self.device = torch.device(device)
        self.cdf = zipf_cdf(n_items, items["exponent"], self.device)
        self.flat: List[np.ndarray] = []
        self.offsets: List[np.ndarray] = []

    def __len__(self) -> int:
        return CHUNK * len(self.flat)

    def _chunk(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds.derive(self.seed, self.stream, j))
        spec = self.length
        z = torch.randn(CHUNK, generator=gen, device=self.device,
                        dtype=torch.float64)
        lengths = torch.exp(math.log(spec["median"]) + spec["sigma"] * z)
        lengths = lengths.round().clamp(spec["min"], spec["max"]).long()
        total = int(lengths.sum())
        u = torch.rand(total, generator=gen, device=self.device,
                       dtype=torch.float64) * self.cdf[-1]
        ids = torch.searchsorted(self.cdf, u).clamp(max=self.n_items - 1) + 1
        offsets = torch.zeros(CHUNK + 1, dtype=torch.int64)
        offsets[1:] = torch.cumsum(lengths.cpu(), 0)
        return ids.to(torch.int32).cpu().numpy(), offsets.numpy()

    def ensure(self, n: int) -> int:
        """Make chunks until requests 0 .. n-1 exist; -> chunks made."""
        made = 0
        while len(self) < n:
            flat, off = self._chunk(len(self.flat))
            self.flat.append(flat)
            self.offsets.append(off)
            made += 1
        return made

    def get(self, i: int) -> np.ndarray:
        j, r = divmod(i, CHUNK)
        off = self.offsets[j]
        return self.flat[j][off[r]:off[r + 1]]

    def lengths(self, ids: np.ndarray) -> np.ndarray:
        """The history lengths of requests ``ids`` (made ones)."""
        every = np.concatenate([np.diff(off) for off in self.offsets])
        return every[np.asarray(ids, dtype=np.int64)]


def arrivals(spec: Dict[str, Any], seed: int, seconds: float) -> np.ndarray:
    """Due times (seconds from the window's start) of an open mix's
    requests in ``[0, seconds)``.  The gaps are drawn in blocks of one
    stream, so a longer span starts with the same arrivals."""
    if spec.get("arrivals") != "poisson":
        raise ValueError("open mixes arrive as a Poisson process")
    rate = rate_per_s(spec)
    rng = seeds.numpy_rng(seed, seeds.ARRIVALS)
    blocks, last = [], 0.0
    while last < seconds:
        due = last + np.cumsum(rng.exponential(1.0 / rate, ARRIVAL_BLOCK))
        blocks.append(due)
        last = float(due[-1])
    due = np.concatenate(blocks)
    return due[due < seconds]
