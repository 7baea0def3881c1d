"""Serving entry point: ``python -m repro_torch.launch.serve [...]``.

Counterpart of the single-model CaloClusterNet path of
``repro/launch/serve.py`` run with ``--train-steps 0 --replicas 1``:
synthetic Belle II events, CaloClusterNet with random weights from a
seed, exported to the IR and deployed through the whole design flow
(``core/pipeline.py:deploy``), micro-batch chunks through the deployed
pipeline, CPS for the trigger bit, and a report of throughput, decision
latency and trigger efficiency / fake rate against the events' truth.

The JAX package's ``launch/serve.py`` serves through
``ShardedTriggerService`` (router, replica threads, in-order release).
This one is a plain in-order loop instead: it dispatches micro-batches
of ``max(pipe.microbatch, 16)`` events — the service's micro-batch
width there — one after another, and brings each one's decisions to
the host before it dispatches the next, so results come back in
submission order. An
event's decision latency is the time from the dispatch of its
micro-batch to its decisions being on the host. As in the reference,
``--precision`` defaults to ``mixed`` (int8 interior, calibrated on 64
events of seed 123), design points 1 to 3 deploy, and
``--no-fuse-gravnet-block`` / ``--no-fuse-int8`` keep the GravNet chain
unfused. The serving layer, training, occupancy buckets and the other
models are not ported yet. The padding-free ragged path has no flag
here, as in the reference: ``build_pipeline(..., ragged=True,
batch=8)`` deploys it and ``serve_events`` serves it.

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import caloclusternet as ccn
from repro_torch.core.pipeline import Requirements, deploy
from repro_torch.data.belle2 import Belle2Config, current_detector, generate

#: the serving micro-batch floor of repro/launch/serve.py
MIN_SERVE_BATCH = 16
#: its default throughput target for the design flow's P search, events/s
TARGET_THROUGHPUT = 1e5


def detector_configs(detector: str):
    """(CCNConfig, Belle2Config) of the 'upgrade' or 'current' detector."""
    if detector == "current":
        return ccn.current_detector_config(), current_detector()
    if detector == "upgrade":
        return ccn.CCNConfig(), Belle2Config()
    raise ValueError(f"unknown detector {detector!r}")


def calibration_feeds(gen_cfg) -> dict:
    """The calibration batch of repro/launch/serve.py: 64 events of
    seed 123."""
    calib = generate(gen_cfg, 64, seed=123)
    return {"hits": calib["feats"], "mask": calib["mask"]}


def build_pipeline(cfg: ccn.CCNConfig, gen_cfg, *, design_point: int = 3,
                   precision: str = "mixed", fuse_gravnet_block: bool = True,
                   fuse_int8: bool = True, batch: int = 1,
                   ragged: bool = False, device=None):
    """Random CaloClusterNet weights from seed 0, exported and
    deployed as repro/launch/serve.py deploys it (its CPU cost
    constants, so the design flow picks the same P and micro-batch;
    its calibration batch from ``gen_cfg``). ``batch`` and ``ragged``
    are ``deploy``'s: ``ragged=True`` returns the padding-free
    ``RaggedPipeline`` with ``batch`` bins per launch."""
    params = ccn.init(torch.Generator().manual_seed(0), cfg)
    req = Requirements(design_point=design_point, platform="cpu",
                       precision_policy=precision, n_hits=cfg.n_hits,
                       target_throughput=TARGET_THROUGHPUT,
                       max_latency_s=2e-3)
    return deploy(ccn.to_graph(params, cfg), req,
                  calibration_feeds=calibration_feeds(gen_cfg),
                  fuse_gravnet_block=fuse_gravnet_block,
                  fuse_int8=fuse_int8, batch=batch, ragged=ragged,
                  device=device)


def _to_host(out) -> dict:
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    return out if isinstance(out, np.ndarray) else out.cpu().numpy()


def serve_events(pipe, feeds: dict):
    """Answer every event of ``feeds`` ({"hits": (E,N,d), "mask": (E,N)}
    numpy) in submission order, ``max(pipe.microbatch, 16)`` events per
    dispatch. ``pipe`` is a deployed pipeline, or a ``RaggedPipeline``
    (its micro-batch is its bins per launch), which returns numpy
    already.

    Returns (results, latencies_s, elapsed_s): the pipeline's outputs
    for all E events as numpy arrays, in order, each event's decision
    latency, and the wall time of the whole loop."""
    batch = max(pipe.microbatch, MIN_SERVE_BATCH)
    n_events = len(feeds["mask"])
    parts, lat = [], np.empty(n_events)
    t0 = time.perf_counter()
    for s in range(0, n_events, batch):
        t_disp = time.perf_counter()
        out = _to_host(pipe({k: v[s:s + batch] for k, v in feeds.items()}))
        lat[s:s + batch] = time.perf_counter() - t_disp
        parts.append(out)
    elapsed = time.perf_counter() - t0

    def cat(*xs):
        if isinstance(xs[0], dict):
            return {k: cat(*(x[k] for x in xs)) for k in xs[0]}
        return np.concatenate(xs, axis=0)

    return cat(*parts), lat, elapsed


def trigger_rates(trigger, truth):
    """(efficiency, fake rate) of trigger decisions against truth."""
    trig = np.asarray(trigger, bool)
    truth = np.asarray(truth) > 0
    eff = float((trig & truth).sum() / max(truth.sum(), 1))
    fake = float((trig & ~truth).sum() / max((~truth).sum(), 1))
    return eff, fake


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--detector", choices=["current", "upgrade"],
                    default="upgrade")
    ap.add_argument("--design-point", type=int, default=3,
                    choices=[1, 2, 3])
    ap.add_argument("--precision", choices=["fp", "mixed"],
                    default="mixed")
    ap.add_argument("--no-fuse-gravnet-block", action="store_true",
                    help="keep the unfused dense→aggregate→dense GravNet "
                         "chains instead of the fused block")
    ap.add_argument("--no-fuse-int8", action="store_true",
                    help="under --precision mixed, keep the unfused "
                         "calibrated int8 chain instead of the quantized "
                         "block; fp deployments still fuse")
    ap.add_argument("--events", type=int, default=512)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="default: cuda (raises when CUDA is absent)")
    args = ap.parse_args(argv)

    cfg, gen_cfg = detector_configs(args.detector)
    pipe = build_pipeline(cfg, gen_cfg, design_point=args.design_point,
                          precision=args.precision,
                          fuse_gravnet_block=not args.no_fuse_gravnet_block,
                          fuse_int8=not args.no_fuse_int8,
                          device=args.device)
    dev = pipe.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"[serve] deployed design point {args.design_point}, "
          f"{args.precision} on {dev} ({name}): "
          f"segments={len(pipe.segments)} microbatch={pipe.microbatch} "
          f"blocks={sum(op.op_type == 'gravnet_block' for op in pipe.graph)}")
    serve_events(pipe, calibration_feeds(gen_cfg))   # first launches

    events = generate(gen_cfg, args.events, seed=7)
    feeds = {"hits": events["feats"], "mask": events["mask"]}
    res, lat, dt = serve_events(pipe, feeds)
    eff, fake = trigger_rates(res["cps"]["trigger"],
                              events["trigger_truth"])
    print(f"[serve] {args.events} events in {dt:.3f}s -> "
          f"{args.events / dt:,.0f} ev/s ({name}, in-order loop, "
          f"{max(pipe.microbatch, MIN_SERVE_BATCH)} events per dispatch)")
    print(f"[serve] latency p50={np.percentile(lat, 50) * 1e6:.0f}us "
          f"p99={np.percentile(lat, 99) * 1e6:.0f}us")
    print(f"[serve] trigger efficiency={eff:.3f} fake rate={fake:.3f} "
          f"answered={len(res['cps']['trigger'])} in-order=True")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
