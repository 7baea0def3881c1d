"""CaloClusterNet through the program: the benchmark's weights, calibration
events and traffic handed to ``repro_torch``'s export, deploy and serving,
and the answers judged against ``reference/caloclusternet.py``."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import counts, traffic
from portbench.reference import caloclusternet as ref

SERVABLE = "ccn"


class Model:
    def __init__(self, cfg: dict, seed: int, device):
        if cfg["deploy"]["precision"] != "mixed":
            raise NotImplementedError("the reference runs the mixed policy")
        self.cfg, self.device = cfg, torch.device(device)
        self.params = ref.make_params(cfg, cfg["weights"],
                                      traffic.derived_seed(seed, "weights"),
                                      self.device)
        cal = traffic.belle2_events(cfg["events"],
                                    cfg["deploy"]["calibration_events"],
                                    traffic.rng(seed, "calibration"))
        self.calib = {"hits": cal["feats"], "mask": cal["mask"]}

    def serve_argv(self) -> list:
        d = self.cfg["deploy"]
        return ["--model", SERVABLE, "--precision", d["precision"],
                "--design-point", str(d["design_point"]),
                "--train-steps", "0", "--device", self.device.type]

    def pool(self, n: int, seed: int) -> dict:
        ev = traffic.belle2_events(self.cfg["events"], n,
                                   traffic.rng(seed, "pool"))
        return {"hits": ev["feats"], "mask": ev["mask"]}

    def deploy(self, args):
        """export_graph and deploy as ``launch/serve.py:build_pipeline``
        does, with the benchmark's weights and calibration events."""
        from repro_torch.core.caloclusternet import CCNConfig
        from repro_torch.core.graph_ir import export_graph
        from repro_torch.core.pipeline import Requirements, deploy
        from repro_torch.launch import serve
        ccfg = CCNConfig(**{f.name: self.cfg[f.name]
                            for f in dataclasses.fields(CCNConfig)
                            if f.name in self.cfg})
        req = Requirements(design_point=args.design_point,
                           platform=args.platform or serve.platform_of(
                               args.device),
                           precision_policy=args.precision,
                           n_hits=ccfg.n_hits,
                           target_throughput=args.target_throughput,
                           max_latency_s=2e-3,
                           tpu_native_gravnet=args.tpu_native_gravnet)
        params = {n: {k: v.clone() for k, v in p.items()}
                  for n, p in self.params.items()}
        return deploy(export_graph("caloclusternet", params, ccfg), req,
                      calibration_feeds=self.calib,
                      fuse_gravnet_block=not args.no_fuse_gravnet_block,
                      fuse_int8=not args.no_fuse_int8, device=args.device)

    # ------------------------------------------------------ the reference ----
    def _tensors(self, feeds):
        return (torch.as_tensor(feeds["hits"], device=self.device),
                torch.as_tensor(feeds["mask"], device=self.device))

    def reference(self, feeds: dict, qmax: int = 127) -> dict:
        """Every event's answer by the plain reference at ``qmax`` (127:
        int8, the configuration's; 7: int4, the control)."""
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            ch, cm = self._tensors(self.calib)
            self.cal = ref.calibrate(self.params, ch, cm, self.cfg, 127)
            cal = self.cal if qmax == 127 else ref.calibrate(
                self.params, ch, cm, self.cfg, qmax)
            h, m = self._tensors(feeds)
            return ref.answers(self.params, cal, h, m, self.cfg)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before

    def control(self, feeds: dict) -> dict:
        """The reference at int4, the precision below the configuration's
        int8."""
        return self.reference(feeds, qmax=7)

    def numbers(self, got: dict, want: dict, n_each) -> dict:
        """The compared numbers over answers ``got`` (stacked), each
        against ``want`` (the reference's answer to the same event) and
        standing for ``n_each`` answers: ``wrong_share``, the share of
        answers whose decisions differ or whose widest gap exceeds
        ``head_steps`` steps of the head's int8 grid; and that widest gap
        (not limited; for the record)."""
        gap, same = ref.answer_gaps(got, want, self.cal, self.cfg)
        wrong = (gap > self.cfg["correct"]["head_steps"]) | ~same
        n_each = np.asarray(n_each, np.float64)
        return {"wrong_share": float((wrong * n_each).sum() / n_each.sum()),
                "widest_gap_steps": float(gap.max())}

    def flops(self) -> float:
        """Model FLOPs an event."""
        return counts.ccn_flops_per_event(self.cfg)

    #: the peak of the precision the configuration states for its products
    peak = counts.PEAK_INT8

    def bound_s(self, events: int) -> float:
        return counts.ccn_mixed_bound_s(self.cfg, events)
