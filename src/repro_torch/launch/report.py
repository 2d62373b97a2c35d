"""The roofline tables from the dry-run's records (the twin of
``repro.launch.report``): one row a cell, a table a mesh.  The meshes are
of ranks (``launch.dryrun`` traces them on a fake process group).

    PYTHONPATH=src python -m repro_torch.launch.report \
        [--out-dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import ARCH_NAMES
from repro_torch.models.common import SHAPES

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def load_all(out_dir):
    recs = {}
    for fn in os.listdir(out_dir):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                r = json.load(f)
            recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def fmt_row(r):
    if r["status"] == "skip":
        return (f"| {r['arch']} | {r['shape']} | skip | — | — | — | — | — "
                f"| — | — |")
    if r["status"] == "fail":
        return f"| {r['arch']} | {r['shape']} | FAIL | | | | | | | |"
    t = r["roofline"]
    dom = t["dominant"][:4]
    return (
        f"| {r['arch']} | {r['shape']} | ok "
        f"| {r['analytic_flops']:.2e} | {r['analytic_bytes']:.2e} "
        f"| {r['collectives']['total_bytes']:.2e} "
        f"| {t['compute_s']*1e3:.2f} / {t['memory_s']*1e3:.2f} / "
        f"{t['collective_s']*1e3:.2f} "
        f"| **{dom}** | {r['useful_flops_ratio']:.2f} "
        f"| {r.get('temp_size_in_bytes', 0)/1e9:.0f} |")


HEADER = ("| arch | shape | st | FLOPs (global) | HBM bytes | coll B/dev "
          "| comp/mem/coll (ms) | bound | useful | temp GB/dev |\n"
          "|---|---|---|---|---|---|---|---|---|---|")


def table(recs, mesh):
    lines = [HEADER]
    for arch in ARCH_NAMES:
        for s in SHAPES:
            r = recs.get((arch, s.name, mesh))
            if r:
                lines.append(fmt_row(r))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    recs = load_all(os.path.abspath(args.out_dir))
    base = {k: v for k, v in recs.items() if "__" not in k[2]}
    ok = sum(1 for r in base.values() if r["status"] == "ok")
    sk = sum(1 for r in base.values() if r["status"] == "skip")
    fl = sum(1 for r in base.values() if r["status"] == "fail")
    print(f"## Dry-run summary: {ok} ok / {sk} skip / {fl} fail "
          f"({len(base)} baseline cells)\n")
    for mesh in ("pod256", "pod512"):
        n = "single-pod 16x16 (256 ranks)" if mesh == "pod256" else \
            "multi-pod 2x16x16 (512 ranks)"
        print(f"### Mesh {n}\n")
        print(table(recs, mesh))
        print()
    variants = sorted(k for k in recs if "__" in k[2])
    if variants:
        print("### §Perf hillclimb variants (vs the baseline rows above)\n")
        print(HEADER)
        for key in variants:
            r = dict(recs[key])
            r["shape"] = f"{r['shape']} [{r['mesh'].split('__', 1)[1]}]"
            print(fmt_row(r))
        print()


if __name__ == "__main__":
    main()
