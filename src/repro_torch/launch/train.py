"""Training launcher: an end-to-end loop with checkpoint/auto-resume and
failure injection, for the seqrec, recsys and dense-LM families.

  PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec-recjpq \
      --steps 200 --batch 32 --ckpt /tmp/ckpt --fail-at 120
  PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec-recjpq \
      --reduced --device cpu --steps 30 --ckpt /tmp/ckpt --fail-at 12

Weights are random (``torch.Generator().manual_seed(0)``, drawn on the
CPU and moved to the device); the data are the reference launcher's
synthetic streams, bit for bit (an LM's: uniform random tokens at
sequence length 64).  ``--device``
defaults to ``cuda`` and the launcher raises when no card is present.  A
failure injected at a step raises before that step's batch is drawn; the
run restarts from the newest checkpoint (after any save still being
written has finished) and the data stream carries on where it was.
``main`` returns the final params and optimizer state, every step's loss,
and every step's wall seconds up to its log line (with ``--log-every 1``
each step waits for its loss, so this is its time end to end).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, get_reduced
from repro_torch.training import checkpoint as ckpt_lib, fault_tolerance as ft
from repro_torch.training import optimizer as opt_lib, train_loop


def make_data(arch, batch_size: int, seed: int = 0, device="cuda"):
    """-> (numpy batch iterator, loss_fn(params, batch), init_fn(generator))
    for ``arch``'s family."""
    cfg = arch.model
    if arch.family == "seqrec":
        from repro_torch.data.sequences import SeqRecDataset
        from repro_torch.models import seqrec as m
        ds = SeqRecDataset.synthetic(
            max(batch_size * 4, 256), cfg.n_items, 10, cfg.max_seq_len,
            seed=seed)
        return (ds.batches(batch_size, cfg.n_negatives,
                           backbone=cfg.backbone, seed=seed),
                lambda p, b: m.seqrec_loss(p, b, cfg),
                lambda gen: m.init_seqrec(gen, cfg, device=device))
    if arch.family == "recsys":
        from repro_torch.data.recsys_data import ctr_batches
        from repro_torch.models import recsys as m
        return (ctr_batches(cfg, batch_size, seed=seed),
                lambda p, b: m.ctr_loss(p, b, cfg),
                lambda gen: m.init_recsys(gen, cfg, device=device))
    if arch.family == "gnn":
        raise NotImplementedError(
            "the gnn family is not ported yet (ROADMAP A 7c)")
    if arch.family == "lm":
        from repro_torch.models import transformer as m
        vocab, seq = cfg.vocab, 64
        rng = np.random.default_rng(seed)

        def gen():
            while True:
                tok = rng.integers(0, vocab, (batch_size, seq + 1))
                yield {"tokens": tok[:, :-1].astype(np.int32),
                       "targets": tok[:, 1:].astype(np.int32)}

        return (gen(), lambda p, b: m.lm_loss(p, b, cfg),
                lambda g: m.init_lm(g, cfg, device=device))
    raise ValueError(arch.family)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, action="append", default=[])
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    data, loss_fn, init_fn = make_data(arch, args.batch, device=dev)
    ocfg = opt_lib.AdamWConfig(lr=args.lr,
                               warmup_steps=max(args.steps // 10, 1),
                               total_steps=args.steps,
                               moment_dtype=arch.model.moment_dtype)
    step_fn = train_loop.make_train_step(loss_fn, ocfg)
    injector = ft.FailureInjector(args.fail_at)
    straggler = ft.StragglerMonitor()
    mgr = ckpt_lib.CheckpointManager(args.ckpt) if args.ckpt else None
    losses, wall_s = {}, {}

    def make_state():
        params = init_fn(torch.Generator().manual_seed(0))
        opt_state = train_loop.init_opt_state(params, ocfg)
        start = 0
        if mgr is not None:
            mgr.wait()
        if mgr is not None and mgr.latest_step() is not None:
            start = mgr.latest_step()
            restored = mgr.restore(start, {"params": params,
                                           "opt_state": opt_state})
            params, opt_state = restored["params"], restored["opt_state"]
            print(f"resumed from step {start}")
        return {"params": params, "opt_state": opt_state, "step": start}

    def train(state, restarts):
        params, opt_state = state["params"], state["opt_state"]
        for step in range(state["step"], args.steps):
            t0 = time.monotonic()
            injector.check(step)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in next(data).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            straggler.record(step, time.monotonic() - t0)
            losses[step] = metrics["loss"]
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            wall_s[step] = time.monotonic() - t0
            if mgr is not None and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, {"params": params, "opt_state": opt_state})
        if mgr is not None:
            mgr.save(args.steps, {"params": params, "opt_state": opt_state},
                     block=True)
            mgr.wait()
        print(f"finished {args.steps} steps "
              f"({len(straggler.flagged)} straggler steps flagged)")
        return {"params": params, "opt_state": opt_state,
                "losses": [float(losses[s]) for s in sorted(losses)],
                "wall_s": [wall_s[s] for s in sorted(wall_s)]}

    return ft.run_with_restarts(make_state, train,
                                max_restarts=args.max_restarts)


if __name__ == "__main__":
    main()
