"""The served model's weights, made from the run's seed on the device.

One generator on the device draws every float weight in one call and
every sub-item code in another, in the types they are served in.  The
float weights' paths and shapes are the configuration's reference's
``layout(cfg)``: the tree the program serves (item id 0 the padding row
of the codes) and the reference reads; both sides get the same tensors.
The scales follow SASRec's usual initialisation: N(0, 1/d_in) for dense
layers, N(0, 0.02^2) for embeddings and sub-item embeddings; the layer
norms' scales and shifts are drawn around 1 and 0, so that a norm applied
wrongly shows in the outputs.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from portbench import seeds

CODE_TYPES = {"uint8": torch.uint8, "uint16": torch.uint16,
              "int16": torch.int16, "int32": torch.int32}


def _put(tree: Dict[str, Any], path: str, value: torch.Tensor) -> None:
    keys = path.split(".")
    node = tree
    for key, nxt in zip(keys[:-1], keys[1:]):
        if key.isdigit():
            node = node[int(key)]
            continue
        node = node.setdefault(key, [] if nxt.isdigit() else {})
        if isinstance(node, list) and nxt.isdigit():
            while len(node) <= int(nxt):
                node.append({})
    node[keys[-1]] = value


def make(cfg: Dict[str, Any], layout: Sequence[Tuple[str, Tuple[int, ...],
                                                   str]],
         seed: int, device) -> Dict[str, Any]:
    """The weight tree of configuration ``cfg`` (its JSON file's dict) for
    ``seed``, on ``device``: the float weights ``layout`` lists (path,
    shape, and how each is drawn: "emb", "dense", "scale" or "shift"),
    then the codes."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.derive(seed, seeds.WEIGHTS))
    total = sum(torch.Size(shape).numel() for _, shape, _ in layout)
    flat = torch.randn(total, generator=gen, device=device)
    tree: Dict[str, Any] = {}
    at = 0
    for path, shape, how in layout:
        n = torch.Size(shape).numel()
        w = flat[at:at + n].view(shape)
        at += n
        if how == "emb":
            w = w.mul_(0.02)
        elif how == "dense":
            w = w.mul_(shape[0] ** -0.5)
        elif how == "scale":
            w = w.mul_(0.1).add_(1.0)
        else:
            w = w.mul_(0.1)
        _put(tree, path, w)
    pq = cfg["pq"]
    code_type = CODE_TYPES[pq["code_dtype"]]
    if pq["b"] > 2 ** 15 and code_type is not torch.int32:
        raise ValueError(f"b={pq['b']} is drawn through int16")
    codes = torch.randint(0, pq["b"], (cfg["n_items"] + 1, pq["m"]),
                          generator=gen, device=device, dtype=torch.int32)
    if code_type is torch.uint16:
        codes = codes.to(torch.int16).view(torch.uint16)
    else:
        codes = codes.to(code_type)
    tree["item_emb"]["codes"] = codes
    return tree
