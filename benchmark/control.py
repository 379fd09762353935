"""The lower-precision control of the check, and the readings the
cells' limits are set from.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--seconds 2] [--out chiprun_out/x.json]

For each seed, one run of the cell (in this process, a short window at
the cell's own load) gives the program's readings; for each control
seed the same run also gives the readings of the plain reference put in
the program's place in bfloat16 on the same inputs. Prints one JSON line
per seed and a summary: the largest reading of the program over the
seeds (the lower reading of each limit) and the smallest of the control
(the upper reading). Needs a card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
# run.py keeps the caches inside the checkout and sets the import path
from run import harness  # noqa: E402

import torch  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a card", file=sys.stderr)
        return 2
    lines = []
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        res, rows = harness.run(args.workload, seed, args.seconds, 0,
                                time.perf_counter(),
                                control=seed in args.control_seeds)
        line = {"seed": seed, "correct": res["correct"],
                "attempted": res["attempted"],
                "program": {k: r["value"] for k, r in rows.items()},
                "control": res.get("control"),
                "throughput": res["metrics"]["info_bit_throughput"]["value"],
                "setup_s": res["metrics"]["setup_s"]["value"],
                "check_s": res["card"]["check_s"],
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        lines.append(line)
    names = lines[0]["program"].keys()
    summary = {"workload": args.workload, "limits": {
        k: r["limit"] for k, r in rows.items()},
        "program_max": {k: max(ln["program"][k] for ln in lines)
                        for k in names},
        "control_min": {k: min(ln["control"][k] for ln in lines
                               if ln["control"]) for k in names}
        if args.control_seeds else None,
        "seeds": len(lines), "control_seeds": len(args.control_seeds)}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": lines,
                                              "summary": summary}) + "\n")
    found = harness.banned_modules()
    if found:
        print(f"loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
