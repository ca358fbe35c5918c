"""The comparison that decides ``correct``.

After the window has closed, a sample of the requests that the timed path
answered in the window, drawn from the seed and holding the longest
history among them, is served again by the plain reference that the
configuration names (its ``reference`` file, passed here as ``ref``)
from the benchmark's own weights and histories.  For each sampled
request and each rank j of its k answers:

* ``score_err``: |served score_j - reference score of served id_j|, the
  largest over the sample.  The served scores are sums of sub-id scores
  of phi, so this is where the backbone, the sub-id scores and the
  kernel's arithmetic show;
* ``topk_gap``: reference's j-th best score - reference score of served
  id_j, the largest over the sample: by how much a served item lies
  below the one the reference ranks there (an item altered, dropped or
  out of order shows here).

The control is the reference itself computed in TF32, judged the same
way against the float32 reference.
"""
from __future__ import annotations

from types import ModuleType
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

NUMBERS = ("score_err", "topk_gap")


def sample(finished: np.ndarray, lengths: np.ndarray, n: int,
           rng: np.random.Generator) -> List[int]:
    """``n`` request ids out of ``finished`` (ascending; ``lengths`` their
    histories' lengths), or all of them where fewer: the longest history
    first (the lowest id among equals), then a draw of the rest."""
    finished = np.asarray(finished, dtype=np.int64)
    if not len(finished):
        return []
    at = int(np.argmax(lengths))
    rest = np.delete(finished, at)
    take = min(n - 1, len(rest))
    picked = rng.choice(len(rest), size=take, replace=False) if take else []
    return [int(finished[at])] + [int(rest[int(j)]) for j in sorted(picked)]


def judge(ref: ModuleType, params: Dict[str, Any], cfg: Dict[str, Any],
          histories: Sequence[np.ndarray], served_ids: np.ndarray,
          served_scores: np.ndarray, device, block: int = 16
          ) -> Dict[str, float]:
    """The two numbers for answers (n, k) to ``histories``, computed in
    blocks of ``block`` requests."""
    out = {name: 0.0 for name in NUMBERS}
    k = served_ids.shape[1]
    for at in range(0, len(histories), block):
        scores = ref.all_scores(params, cfg, histories[at:at + block],
                                device)
        best, _ = ref.top_k(scores, k)
        ids = torch.as_tensor(served_ids[at:at + block], dtype=torch.int64,
                              device=scores.device)
        got = torch.as_tensor(served_scores[at:at + block],
                              dtype=torch.float32, device=scores.device)
        at_served = torch.gather(scores, 1, ids)
        out["score_err"] = max(out["score_err"],
                               float((got - at_served).abs().max()))
        out["topk_gap"] = max(out["topk_gap"],
                              float((best - at_served).max()))
        del scores
    return out


def control_answers(ref: ModuleType, params: Dict[str, Any],
                    cfg: Dict[str, Any],
                    histories: Sequence[np.ndarray], k: int, device,
                    block: int = 16):
    """The control's answers: the reference in TF32 put in the program's
    place.  -> (ids (n, k), scores (n, k)) as numpy arrays."""
    ids, vals = [], []
    for at in range(0, len(histories), block):
        scores = ref.all_scores(params, cfg, histories[at:at + block],
                                device, precision="tf32")
        v, i = ref.top_k(scores, k)
        ids.append(i.cpu().numpy())
        vals.append(v.cpu().numpy())
        del scores
    return np.concatenate(ids), np.concatenate(vals)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Each number at or under its limit (a NaN fails)."""
    return all(numbers[name] <= limits[name] for name in NUMBERS)
