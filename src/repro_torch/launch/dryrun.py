"""The dry-run: every cell's step on the production meshes, on the CPU.

Counterpart of ``repro/launch/dryrun.py``. Run it in its own process
(the world it starts is global to the process):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k --mesh single

For each cell and mesh it starts a ``fake`` world of 256 (16×16) or 512
(2×16×16) ranks, runs the step once on fake DTensors placed by the
cell's shardings (``Cell.lower``: nothing is allocated, no data moves,
no card is needed; the multi-pod mesh traced as its pod·data × model
equivalent, ``launch/mesh.traced_mesh``), and writes one JSON report with the reference's
keys: ``memory`` (argument and output bytes per device exact, temp the
peak of the local tensors held at once), ``per_device`` (FLOPs, bytes,
collective bytes), ``collectives`` (bytes and counts per kind),
``model_flops``, ``roofline`` (the H100 datasheet model of
``launch/mesh.py``), and for the LM cells on the single-pod mesh the
reference's reduced-L cost variants (``cost_variants``, L 2 and 4) and
their affine composition at the full L (``per_device_corrected``).
The models' kernels run their plain versions here (fake CPU tensors),
as the reference's dry-run lowers its ``xla`` path on host devices.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch import configs
from repro_torch.launch import analysis
from repro_torch.launch.mesh import (fake_world, make_production_mesh,
                                     traced_mesh)

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "torch_dryrun")


def _check_pod(cell, mesh) -> None:
    """On the multi-pod mesh every sharding names "pod" only beside
    "data" (DP), so the pod·data mesh of ``traced_mesh`` shards alike."""
    from repro_torch.dist.sharding import map_leaves
    bad = []

    def check(sh):
        for e in sh.spec:
            names = e if isinstance(e, tuple) else (e,)
            if "pod" in names and tuple(names[:2]) != ("pod", "data"):
                bad.append(sh.spec)
        return sh
    map_leaves(check, cell.resolve_shardings(mesh),
               is_leaf=lambda x: hasattr(x, "placements"))
    if bad:
        raise ValueError(f"{cell.name}: pod apart from data in {bad[:3]}")


def run_cell(arch: str, shape: str, *, multi_pod: bool, cost_pass: bool,
             report_dir: str, force: bool = False) -> dict:
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    out_path = os.path.join(report_dir, f"{arch}__{shape}__{mesh_tag}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    mod = configs.get_arch(arch)
    cell = mod.cell(shape)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_chips = mesh.size()
        _check_pod(cell, mesh)
        mesh = traced_mesh(mesh)
        t0 = time.time()
        lowered = cell.lower(mesh)
        t_lower = time.time() - t0
        terms = analysis.cost_terms(lowered)
        rec = {
            "arch": arch, "shape": shape, "mesh": mesh_tag,
            "kind": cell.kind, "n_chips": n_chips,
            "t_lower_s": round(t_lower, 2), "t_compile_s": 0.0,
            "memory": lowered["memory"],
            "per_device": {k: terms[k] for k in
                           ("flops", "bytes", "collective_bytes")},
            "collectives": terms["collectives"],
            "model_flops": cell.model_flops,
        }
        print(f"[dryrun] {arch}:{shape} @{mesh_tag}  "
              f"traced {t_lower:.1f}s")
        print(f"  memory: {rec['memory']}")
        print(f"  cost: flops={terms['flops']:.3e} "
              f"bytes={terms['bytes']:.3e} "
              f"coll={terms['collective_bytes']:.3e}")

        # LM archs: the reference's reduced-L composition (single-pod)
        if cost_pass and mod.FAMILY == "lm" and not multi_pod:
            from repro_torch.configs import lm_common
            quant = arch.startswith("llama4")
            ccells, l_full = lm_common.cost_cells(
                arch, mod.full_config(), shape, quantize_opt=quant)
            sub = {}
            for lred, c2 in ccells.items():
                t0 = time.time()
                sub[lred] = analysis.cost_terms(c2.lower(mesh))
                print(f"  cost-variant L={lred}: flops="
                      f"{sub[lred]['flops']:.3e} ({time.time()-t0:.1f}s)")
            rec["per_device_corrected"] = analysis.affine_extrapolate(
                sub[2], sub[4], l_full)
            rec["cost_variants"] = {str(k): {kk: v[kk] for kk in
                                             ("flops", "bytes",
                                              "collective_bytes")}
                                    for k, v in sub.items()}

    effective = rec.get("per_device_corrected", rec["per_device"])
    rec["roofline"] = analysis.roofline(effective, n_chips=n_chips,
                                        model_flops=cell.model_flops)
    os.makedirs(report_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--no-cost-pass", action="store_true")
    ap.add_argument("--include-paper", action="store_true",
                    help="also dry-run caloclusternet cells")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--report-dir", default=os.path.normpath(REPORT_DIR))
    args = ap.parse_args(argv)

    cells = []
    for arch, shape, mod in configs.all_cells(
            include_paper=args.include_paper):
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape != args.shape:
            continue
        cells.append((arch, shape))

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    t_all = time.time()
    for arch, shape in cells:
        for multi in meshes:
            try:
                run_cell(arch, shape, multi_pod=multi,
                         cost_pass=not args.no_cost_pass,
                         report_dir=args.report_dir, force=args.force)
            except Exception as e:  # keep going, report at end
                failures.append((arch, shape, multi, repr(e)))
                traceback.print_exc()
    print(f"\n[dryrun] {len(cells) * len(meshes) - len(failures)} ok, "
          f"{len(failures)} failed, {time.time() - t_all:.1f}s")
    for f_ in failures:
        print("  FAILED:", f_)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
