"""The hill-climb: hypothesis → change → re-trace → re-analyse, on three
dry-run cells.

Counterpart of ``repro/launch/hillclimb.py``. Run it in its own process
(the world it starts is global to the process), as the dry-run:

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --exp trigger

Each experiment changes one option of a cell, traces the changed cell on
the (16, 16) production mesh of a ``fake`` world of 256 ranks
(``launch/dryrun.py``'s way: ``Cell.lower`` on fake DTensors, no card),
and writes one JSON report per step: ``memory``, ``per_device`` (FLOPs,
bytes, collective bytes), ``collectives`` (counts by kind), for the LM
cells ``per_device_corrected`` (the reduced-L affine composition), the
``roofline`` of the H100 datasheet model (``launch/mesh.py``) and the
``hypothesis`` it tests. The reports are that model's, not a time on
the card. The cells:

- A (``exp_decode``): yi-9b decode_32k; A1 serving shardings (TP-only
  weights), A2 with an int8 KV cache;
- B (``exp_train``): granite-34b train_4k; B1 sequence-parallel residual
  stream, B2 with 4 gradient-accumulation microbatches, B3 with int8
  optimizer moments;
- C (``exp_trigger``): caloclusternet trigger_serve; C1 bf16 serving
  activations (``compute_dtype``), C2 with the one-hot cell
  (``gravnet_impl``).

Each reads its baseline from the dry-run's report of its cell at
(16, 16) in ``--baseline-dir`` (``reports/torch_dryrun/``; a missing
one is made there first by ``dryrun.run_cell``) and writes to
``--report-dir`` (``reports/torch_hillclimb/``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch import configs
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     traced_mesh)

_REPORTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "reports")
REPORT_DIR = os.path.normpath(os.path.join(_REPORTS, "torch_hillclimb"))
BASELINE_DIR = os.path.normpath(dryrun.REPORT_DIR)


def measure(cell, *, cost_cells=None, l_full=None):
    """One changed cell traced on the production mesh (inside a fake
    world of 256): its cost terms, memory and roofline."""
    mesh = traced_mesh(make_production_mesh())
    t0 = time.time()
    lowered = cell.lower(mesh)
    terms = analysis.cost_terms(lowered)
    rec = {"memory": lowered["memory"],
           "per_device": {k: terms[k] for k in
                          ("flops", "bytes", "collective_bytes")},
           "collectives": terms["collectives"]["counts"],
           "t_lower_s": round(time.time() - t0, 1)}
    if cost_cells is not None:
        sub = {lred: analysis.cost_terms(c2.lower(mesh))
               for lred, c2 in cost_cells.items()}
        rec["per_device_corrected"] = analysis.affine_extrapolate(
            sub[2], sub[4], l_full)
    eff = rec.get("per_device_corrected", rec["per_device"])
    rec["roofline"] = analysis.roofline(eff, n_chips=mesh.size(),
                                        model_flops=cell.model_flops)
    return rec


def report(tag, hypothesis, rec, baseline=None, *, report_dir=REPORT_DIR):
    """Print one step's line (the roofline's three terms, the dominant
    one, memory, useful FLOPs, the step against ``baseline``) and write
    its report, the hypothesis with it."""
    rf = rec["roofline"]
    mem_gib = (rec["memory"]["argument_size_in_bytes"]
               + rec["memory"]["temp_size_in_bytes"]
               + rec["memory"]["output_size_in_bytes"]) / 2 ** 30
    line = (f"[{tag}] C={rf['t_compute_s'] * 1e3:.3f}ms "
            f"M={rf['t_memory_s'] * 1e3:.3f}ms "
            f"X={rf['t_collective_s'] * 1e3:.3f}ms "
            f"dom={rf['dominant']} mem={mem_gib:.2f}GiB "
            f"useful={rf['useful_flops_ratio']:.2f}")
    if baseline is not None:
        b = baseline["roofline"]
        st_b = max(b["t_compute_s"], b["t_memory_s"], b["t_collective_s"])
        st_n = max(rf["t_compute_s"], rf["t_memory_s"],
                   rf["t_collective_s"])
        line += (f"  step {st_b * 1e3:.2f}->{st_n * 1e3:.2f}ms "
                 f"({st_b / max(st_n, 1e-12):.1f}x)")
    print(line, flush=True)
    os.makedirs(report_dir, exist_ok=True)
    rec["hypothesis"] = hypothesis
    with open(os.path.join(report_dir, f"{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def _baseline(arch, shape, baseline_dir):
    """The dry-run's report of the cell at (16, 16), its roofline and
    memory; run outside a world (``run_cell`` starts its own)."""
    base = dryrun.run_cell(arch, shape, multi_pod=False, cost_pass=True,
                           report_dir=baseline_dir)
    print(f"[{arch}:{shape} baseline] dom={base['roofline']['dominant']} "
          f"X={base['roofline']['t_collective_s']}", flush=True)
    return {"roofline": base["roofline"], "memory": base["memory"]}


# ------------------------------------------------------------ experiments ----
def exp_decode(*, baseline_dir=BASELINE_DIR, report_dir=REPORT_DIR):
    """Cell A: yi-9b:decode_32k (the most collective-bound)."""
    from repro_torch.configs import lm_common
    cfg = configs.get_arch("yi-9b").full_config()
    base_rec = _baseline("yi-9b", "decode_32k", baseline_dir)
    with fake_world(256):
        # A1: serving shardings (TP-only params; no per-step FSDP gathers)
        hyp = ("the baseline's collective term (44.5 ms: 2.2 GB a device "
               "at H100_LINK_BW, 50 GB/s) is the FSDP all-gather of the "
               "weights every decode step: yi-9b's 8.8e9 parameters, "
               "sharded over data and model, gathered over data each "
               "step; TP-only serving shardings keep each device's 1/16 "
               "resident and gather nothing; predict X falls more than "
               "10x and the memory term (12.3 ms of bytes at "
               "H100_HBM_BW, 3.35 TB/s) dominates")
        cell = lm_common.decode_cell("yi-9b", cfg, "decode_32k",
                                     serving_shardings=True)
        cc, lf = lm_common.cost_cells("yi-9b", cfg, "decode_32k",
                                      serving_shardings=True)
        a1 = report("A1_yi9b_decode_serving_tp", hyp,
                    measure(cell, cost_cells=cc, l_full=lf), base_rec,
                    report_dir=report_dir)

        # A2: + int8 KV cache with per-token scales
        hyp2 = ("the memory term is then the KV cache's reads (B 128 x "
                "32768 x 48 layers x 2 x 4 kv heads x 128 in bf16, 412 GB, "
                "1.6 GB a device) beside the weights' and activations'; "
                "an int8 cache halves the cache's reads, but the port's "
                "decode dequantizes each layer's cache into a bf16 copy "
                "that it writes and reads again (the model counts every "
                "op's inputs and outputs); predict M (bytes at "
                "H100_HBM_BW) between 0.9x and 1.3x of A1's, not the "
                "reference's 0.65x")
        cfg8 = dataclasses.replace(cfg, kv_cache_int8=True)
        cell = lm_common.decode_cell("yi-9b", cfg8, "decode_32k",
                                     serving_shardings=True)
        cc, lf = lm_common.cost_cells("yi-9b", cfg8, "decode_32k",
                                      serving_shardings=True)
        report("A2_yi9b_decode_serving_tp_kv8", hyp2,
               measure(cell, cost_cells=cc, l_full=lf), a1,
               report_dir=report_dir)


def exp_train(*, baseline_dir=BASELINE_DIR, report_dir=REPORT_DIR):
    """Cell B: granite-34b:train_4k (the worst roofline; 216 GiB of temp
    a device at baseline, past the H100's 80 GB)."""
    from repro_torch.configs import lm_common
    cfg = configs.get_arch("granite-34b").full_config()
    base_rec = _baseline("granite-34b", "train_4k", baseline_dir)
    with fake_world(256):
        # B1: sequence-parallel residual stream
        hyp = ("the baseline keeps the (B/dp 16, S 4096, D 6144) residual "
               "stream replicated over tp at every one of 88 layers (805 "
               "MB a layer in bf16); sharding its seq dim over tp=16 "
               "between blocks cuts the residual path's activations and "
               "bytes up to 16x; predict temp 216 GiB -> 15-60 GiB and "
               "the memory term (54.2 s at H100_HBM_BW) 0.3-0.8x")
        cfg1 = dataclasses.replace(cfg, seq_parallel=True)
        cell = lm_common.train_cell("granite-34b", cfg1)
        cc, lf = lm_common.cost_cells("granite-34b", cfg1, "train_4k")
        b1 = report("B1_granite34b_train_seqpar", hyp,
                    measure(cell, cost_cells=cc, l_full=lf), base_rec,
                    report_dir=report_dir)

        # B2: + gradient accumulation (4 microbatches)
        hyp2 = ("the live activations scale with the microbatch: 4 "
                "sequential microbatches cut them about 4x at the same "
                "FLOPs; the FSDP weight gathers repeat per microbatch; "
                "predict temp /2-4, bytes within 1.2x, collective bytes "
                "up to 4x (X at H100_LINK_BW, 50 GB/s)")
        cell = lm_common.train_cell("granite-34b", cfg1, grad_accum=4)
        cc, lf = lm_common.cost_cells("granite-34b", cfg1, "train_4k",
                                      grad_accum=4)
        b2 = report("B2_granite34b_train_seqpar_ga4", hyp2,
                    measure(cell, cost_cells=cc, l_full=lf), b1,
                    report_dir=report_dir)

        # B3: + int8 optimizer moments
        hyp3 = ("f32 master weights and two f32 moments are 12 B a "
                "parameter, 34e9 x 12 / 256 = 1.6 GB a device of "
                "optimizer traffic; int8 moments with scales cut the "
                "moments' 8 B to about 2 B, but the port packs them on "
                "gathered copies (the llama4 train cell's dry-run); "
                "predict argument bytes -30 to -45%, total bytes (M at "
                "H100_HBM_BW) within 5%, temp up to 1.5x")
        cell = lm_common.train_cell("granite-34b", cfg1, grad_accum=4,
                                    quantize_opt=True)
        cc, lf = lm_common.cost_cells("granite-34b", cfg1, "train_4k",
                                      grad_accum=4, quantize_opt=True)
        report("B3_granite34b_train_seqpar_ga4_q8opt", hyp3,
               measure(cell, cost_cells=cc, l_full=lf), b2,
               report_dir=report_dir)


def exp_trigger(*, baseline_dir=BASELINE_DIR, report_dir=REPORT_DIR):
    """Cell C: caloclusternet:trigger_serve (the paper's cell)."""
    import repro_torch.configs.caloclusternet as ccncfg
    base_rec = _baseline("caloclusternet", "trigger_serve", baseline_dir)
    with fake_world(256):
        # C1: bf16 serving activations
        hyp = ("trigger serving is collective- then bytes-bound (0.93 ms "
               "of X at H100_LINK_BW, 0.11 ms of M at H100_HBM_BW): 16 "
               "events a device of 128 hits through small denses; bf16 "
               "feats and weights halve the denses' activation bytes and "
               "the gathers of bf16 tensors, while the GravNet "
               "aggregation keeps its (n, n) distances and weights in "
               "f32, as the reference's oracle does; predict M 0.6-0.9x "
               "and X 0.5-1.0x")
        cell = _ccn_variant(ccncfg, compute_dtype="bf16")
        c1 = report("C1_ccn_serve_bf16", hyp, measure(cell), base_rec,
                    report_dir=report_dir)

        # C2: + the one-hot cell instead of top-k + gather
        hyp2 = ("top-k + gather builds the (n, n) distances with one "
                "batched matrix product and sorts each row once; the "
                "one-hot cell (the kernels' schedule in plain PyTorch) "
                "builds them by d_s separate product and sum passes, then "
                "takes k = 8 argmin rounds, each reading the matrix, "
                "gathering a neighbour row and writing the knocked-out "
                "matrix; on the H100 model that is bytes at H100_HBM_BW, "
                "not FLOPs at H100_PEAK_FLOPS_BF16; predict M 2-6x of "
                "C1's, X unchanged (the events stay on their device)")
        cell = _ccn_variant(ccncfg, compute_dtype="bf16",
                            gravnet_impl="onehot")
        report("C2_ccn_serve_bf16_onehot", hyp2, measure(cell), c1,
               report_dir=report_dir)


def _ccn_variant(ccncfg, **over):
    cfg = dataclasses.replace(ccncfg.full_config("upgrade"), **over)
    return ccncfg._serve_cell(cfg, "trigger_serve", 4096)


def main(argv=None):
    ap = argparse.ArgumentParser(description="dry-run hill-climb")
    ap.add_argument("--exp", choices=["decode", "train", "trigger", "all"],
                    default="all")
    ap.add_argument("--report-dir", default=REPORT_DIR)
    ap.add_argument("--baseline-dir", default=BASELINE_DIR)
    args = ap.parse_args(argv)
    dirs = dict(baseline_dir=args.baseline_dir, report_dir=args.report_dir)
    if args.exp in ("decode", "all"):
        exp_decode(**dirs)
    if args.exp in ("train", "all"):
        exp_train(**dirs)
    if args.exp in ("trigger", "all"):
        exp_trigger(**dirs)


if __name__ == "__main__":
    main()
