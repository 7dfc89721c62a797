"""Markdown table of an LM dry-run sweep's records.

Reads the JSON records ``repro_torch.launch.dryrun`` writes (one file a
combo) and prints one row an arch, one column a shape; a cell holds, for
the pod (256 ranks) and then the multi-pod mesh (512), the status or the
per-device peak estimate in GB, the dominant roofline term (C compute, M
memory, X collective) and the useful-FLOP ratio.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  python tools/lm_dryrun_table.py experiments/dryrun_torch
"""
import glob
import json
import os
import sys

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("pod", "multipod")
TERM = {"compute": "C", "memory": "M", "collective": "X"}


def cell(rec) -> str:
    if rec is None:
        return "-"
    if rec["status"] != "ok":
        return rec["status"]
    gb = rec["memory"]["peak_estimate_bytes"] / 1e9
    roof = rec.get("roofline")
    if roof is None:
        return f"{gb:.1f}"
    return f"{gb:.1f} {TERM[roof['dominant']]} {roof['useful_flops_ratio']:.3f}"


def main(out_dir: str) -> int:
    recs = {}
    for path in glob.glob(os.path.join(out_dir, "*.json")):
        with open(path) as f:
            rec = json.load(f)
        recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    archs = sorted({a for a, _, _ in recs}, key=lambda a: a.lower())
    print("| Arch | " + " | ".join(SHAPES) + " |")
    print("| --- |" + " --- |" * len(SHAPES))
    for arch in archs:
        cells = [" / ".join(cell(recs.get((arch, s, m))) for m in MESHES)
                 for s in SHAPES]
        print(f"| {arch} | " + " | ".join(cells) + " |")
    fails = [r for r in recs.values() if r["status"] == "fail"]
    for r in fails:
        print(f"\nfail: {r['arch']} {r['shape']} {r['mesh']}: "
              f"{r['error'][:300]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1
                  else "experiments/dryrun_torch"))
