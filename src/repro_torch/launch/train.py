"""Training driver: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of ``repro/launch/train.py``, on the card unless
``--device cpu`` is given:

  data Prefetcher (seeded, resume-exact) →
  the train step, captured on the card as one CUDA graph (forward,
  gradients, AdamW, the new state copied into its buffers; the
  counterpart of the reference's ``jax.jit``) →
  CheckpointManager (async, atomic, rotating; the reference's on-disk
  format, so either package resumes the other's checkpoints) →
  supervision loop with failure injection + restore-and-resume (the
  restore copies into the captured step's buffers).

Each arch trains at its smoke config, as the reference does: the paper's
own architecture (caloclusternet) the object-condensation loss on the
synthetic Belle II generator, the five LMs the chunked cross-entropy on
the synthetic token stream (``data/lm.py``, 64 tokens a row), MIND the
in-batch sampled softmax on ``data/recsys.py``'s users. A GNN arch has no
generic stream, as in the reference (``configs/gnn_common`` and
``configs/graphsage_reddit`` hold their steps).
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time
from typing import NamedTuple

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import Prefetcher
from repro_torch.device import resolve_device
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_warmup)
from repro_torch.optim.step import CompiledStep, value_and_grad

def make_data_stream(arch: str, mod, smoke_cfg, batch: int, seed: int,
                     start_step: int):
    """The arch's seeded batch stream from ``start_step`` on (batch t of
    a stream resumed at s is batch s + t of an unbroken one)."""
    if mod.FAMILY == "lm":
        from repro_torch.data.lm import lm_stream
        return lm_stream(smoke_cfg.vocab, batch, 64, seed=seed,
                         start_step=start_step)
    if mod.FAMILY == "recsys":
        from repro_torch.data.recsys import mind_stream
        return mind_stream(smoke_cfg, batch, seed=seed,
                           start_step=start_step)
    if mod.FAMILY == "trigger":
        from repro_torch.data.belle2 import Belle2Config, event_stream
        gen = Belle2Config(n_crystals=576, grid=(24, 24),
                           n_hits=smoke_cfg.n_hits, noise_rate=4.0)
        return event_stream(gen, batch, seed0=seed + start_step)
    raise ValueError(f"no generic stream for family {mod.FAMILY}; "
                     "use examples/ drivers for GNN archs")


def build_step(arch: str, mod, cfg, device=None):
    """(step, init_params, to_batch, ocfg): the reduced-scale train step
    ``step(params, opt, batch) -> (new params, new opt, metrics)``
    (functional; :class:`CompiledStep` captures it on the card),
    ``init_params(seed)`` (random weights from a ``torch.Generator``, on
    the device), ``to_batch(raw)`` (a stream's numpy batch as tensors on
    the device) and the AdamW config."""
    from repro_torch.optim.adamw import tree_map
    dev = resolve_device(device)
    ocfg = AdamWConfig()
    lr = cosine_warmup(peak_lr=3e-4, warmup_steps=20, total_steps=2000)

    if mod.FAMILY == "lm":
        from repro_torch.models import transformer as tr

        def loss_fn(p, b):
            return tr.loss_fn(p, b, cfg, None)
        init = tr.init_params
        keys = ("tokens", "labels")
    elif mod.FAMILY == "recsys":
        from repro_torch.models import recsys as rec

        def loss_fn(p, b):
            return rec.loss_fn(p, b, cfg)
        init = rec.init
        keys = ("behav_ids", "behav_mask", "tag_ids", "target")
    elif mod.FAMILY == "trigger":
        from repro_torch.core import caloclusternet as ccn
        from repro_torch.core.condensation import condensation_loss

        def loss_fn(p, b):
            out = ccn.apply(p, b["feats"], b["mask"], cfg)
            labels = {"object_id": b["object_id"], "energy": b["energy"],
                      "cls": b["cls"]}
            return condensation_loss(out, labels, b["mask"],
                                     k_max=cfg.k_max)
        init = ccn.init
        keys = ("feats", "mask", "object_id", "energy", "cls")
    else:
        raise ValueError(mod.FAMILY)

    def init_params(seed: int):
        return tree_map(lambda t: t.to(dev),
                        init(torch.Generator().manual_seed(seed), cfg))

    def to_batch(raw):
        return {k: torch.from_numpy(raw[k]).to(dev) for k in keys}

    def step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(
            lambda p: loss_fn(p, batch), params)
        new_p, new_s, aux = adamw_update(grads, opt_state, params,
                                         lr=lr(opt_state["step"]), cfg=ocfg)
        return new_p, new_s, {**metrics, **aux, "loss": loss}

    return step, init_params, to_batch, ocfg


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"),
        help="checkpoint directory (default: repro_torch_ckpt in the "
             "temporary directory; a reference checkpoint there resumes)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=None,
                    help="simulate a node failure at this step "
                         "(exercises restore-and-resume)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without CUDA) or cpu")
    return ap.parse_args(argv)


class Report(NamedTuple):
    """One training run, for callers that check it (``chip_smoke.py``):
    the parsed arguments, the device, the step it started from (a
    resumed checkpoint's, else 0) and the step it ended at, each
    injected failure's (at step, resumed from step), every step's loss
    in the order run (``(step, loss)``; a step redone after a restore
    appears again), the checkpoints saved, the final state (the step's
    buffers), the prefetcher's stragglers, the run's wall time and
    steps/s, and whether the step was captured."""
    args: argparse.Namespace
    device: torch.device
    start: int
    final_step: int
    resumes: list
    losses: list
    checkpoints: list
    params: dict
    opt: dict
    stragglers: int
    elapsed_s: float
    steps_per_s: float
    captured: bool


def run(argv=None, *, capture_backend=None) -> Report:
    """The command line's run; prints the reference's lines and returns
    the :class:`Report`. ``capture_backend`` replaces the card's CUDA
    graphs (a test's stand-in on the CPU)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mod = configs.get_arch(args.arch)
    cfg = mod.smoke_config()
    step, init_params, to_batch, ocfg = build_step(args.arch, mod, cfg,
                                                   device=dev)
    mgr = CheckpointManager(args.ckpt_dir, keep=3, async_=True)
    params = init_params(args.seed)
    stepper = CompiledStep(step, params, adamw_init(params, ocfg),
                           device=dev, backend=capture_backend)

    def state():
        return {"p": stepper.params, "o": stepper.opt}

    def restore_latest():
        restored, rstep = mgr.restore_latest(state())
        stepper.load(restored["p"], restored["o"])
        return rstep

    start = 0
    if mgr.latest() is not None:
        start = restore_latest()
        print(f"[train] resumed from step {start}")

    stream = make_data_stream(args.arch, mod, cfg, args.batch, args.seed,
                              start)
    injected = False
    resumes, trace, saved = [], [], []
    metrics = None
    s = start
    t0 = time.time()
    pf = Prefetcher(stream, depth=2)
    try:
        while s < args.steps:
            if (args.inject_failure_at is not None and not injected
                    and s == args.inject_failure_at):
                injected = True
                print(f"[train] >>> injected node failure at step {s}; "
                      "restoring from last checkpoint")
                mgr.wait()
                if mgr.latest() is None:
                    print("[train] no checkpoint yet; restarting step")
                else:
                    at, s = s, restore_latest()
                    resumes.append((at, s))
                    stream = make_data_stream(args.arch, mod, cfg,
                                              args.batch, args.seed, s)
                    pf.close()
                    pf = Prefetcher(stream, depth=2)
                continue
            metrics = stepper(to_batch(pf.get()))
            s += 1
            # a device copy: the loss is read on the host every
            # --log-every steps only
            trace.append((s, metrics["loss"].clone()))
            if s % args.log_every == 0:
                loss = float(metrics["loss"])
                rate = (s - start) / (time.time() - t0)
                print(f"[train] step {s} loss {loss:.4f} "
                      f"({rate:.1f} steps/s, "
                      f"stragglers={pf.stats['stragglers']})")
            if s % args.ckpt_every == 0:
                mgr.save(s, state())
                saved.append(s)
    finally:
        pf.close()
    mgr.wait()
    elapsed = time.time() - t0
    stragglers = pf.stats["stragglers"]
    if metrics is None:
        print(f"[train] nothing to do: at step {s} of {args.steps}")
    else:
        print(f"[train] done at step {s}; final loss "
              f"{float(metrics['loss']):.4f}")
    losses = list(zip([st for st, _ in trace], torch.stack(
        [v for _, v in trace]).tolist() if trace else []))
    return Report(args, dev, start, s, resumes, losses, saved,
                  stepper.params, stepper.opt, stragglers, elapsed,
                  len(trace) / elapsed if elapsed > 0 else math.nan,
                  stepper.captured)


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
