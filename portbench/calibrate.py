"""The readings a cell's limits are set from, at the cell's own size, on the
card, in one process (the set-up is paid once).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--controls 3]

For every seed: the program's first three steps against the float32
reference (the lower readings), with the elements of the parameters whose
first step differs by more than half the learning rate between the two
(an AdamW step of opposite sign: the first update is about lr * sign(g)
for every element whose gradient is well above ``eps``).  For the first ``--controls`` seeds also
the control, the reference put in the program's place in TF32, and the
faults a training cell can have, planted in the reference put in the
program's place (half the batch, the exchange left out, a shifted draw),
each against the float32 reference (the upper readings).  A step that
returns its state unchanged reads 1 on ``change1`` by the measure and needs
no run.  One JSON line per seed on standard output; the benchmark's runs
never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from portbench import compare, dataset, harness, reference

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_bench(ROOT)
    cell = harness.find_cell(bench, args.workload)
    cfg_file = harness.config_path(ROOT, bench, cell["config"])
    cfg = json.loads(cfg_file.read_text())
    mix = harness.load_mix(ROOT, bench, cell["traffic"])
    data, _ = dataset.load_or_build(cfg_file, ROOT / "build" / "portbench",
                                    mix["num_parts"], mix["partitioner"],
                                    log=lambda *a: print(*a, file=sys.stderr))
    seeds = [int(s) for s in args.seeds.split(",")]
    net = reference.load_model(harness.bench_dir(ROOT, bench) / "models",
                               cfg["model"]["conv"])
    prog = harness.Program(data, cfg, mix, harness.seed_streams(seeds[0]),
                           "cuda", net, harness.gnn_config(cfg["model"]))
    layout = reference.make_layout(data, mix["num_parts"], "cuda")
    for i, seed in enumerate(seeds):
        s = harness.seed_streams(seed)
        prog.start(s)
        first_prog, first_ref = [], []
        got = prog.checked_steps(after_first=first_prog)
        torch.cuda.synchronize()
        ref_args = (data, net, cfg["model"], cfg["optimizer"], mix,
                    s["weights"], s["base_salt"], s["dropout"])
        t0 = time.perf_counter()
        ref = reference.train(*ref_args, device="cuda", layout=layout,
                              after_first=first_ref)
        torch.cuda.synchronize()
        lr = cfg["optimizer"]["lr"]
        flips = {k: int(((v - first_ref[0][k]).abs() > lr / 2).sum())
                 for k, v in first_prog[0].items()}
        row = {"seed": seed, "reference_s": time.perf_counter() - t0,
               "flips": {k: v for k, v in flips.items() if v},
               "reference": ref, "program": got,
               "readings": {"program": compare.readings(got, ref)}}
        if i < args.controls:
            runs = {"control": reference.train(
                *ref_args, device="cuda", layout=layout, precision="tf32")}
            for fault in reference.FAULTS:
                runs[fault] = reference.train(*ref_args, device="cuda",
                                              layout=layout, fault=fault)
            row.update(runs)
            for name, r in runs.items():
                row["readings"][name] = compare.readings(r, ref)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
