"""The readings a cell's output limits are set from, on the card.

    python3 portbench/tools/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out FILE]

For each seed, in one process: the program set up as a run sets it up,
then serving, one after another at the cell's load (b = 1), as many
requests as a run compares (``check_requests``): the mix's longest
prompt and the schedule's first others.  The plain reference computes
their logits again, and the compared numbers of the program's logits
are printed (``program``).  For the control seeds the reference at the
precision below the configuration's (every int8 operand at int4) takes
the program's place and is compared the same way (``control``).  One
JSON line a reading; the maxima and minima last.
"""

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench.harness import guard, main, spec  # noqa: E402
from portbench.reference.dense import (NUMBERS, numbers,  # noqa: E402
                                      per_request)


def requests_of(st: main.Setup, k: int) -> list:
    """The mix's longest prompt and the schedule's first ``k - 1``."""
    return [(max(st.schedule.base), 0)] + st.schedule.take(k - 1)


def served(cell, seed: int, device, impl: str):
    """The program's window over the readings' requests, and its pool."""
    st = main.set_up(cell, seed, device, impl)
    win = main.serve_window(st, 0.0, requests=requests_of(
        st, int(cell.traffic["check_requests"])))
    pool = st.pool
    del st
    gc.collect()
    torch.cuda.empty_cache()
    return win, pool


def row(seed, side, logits, ref, lengths, **extra) -> dict:
    per = per_request(logits, ref)
    return {"seed": seed, "side": side, **numbers(logits, ref), **extra,
            "per_request": [[n, r] for n, r in zip(lengths, per)]}


def read_seed(cell, seed: int, control: bool, plain: bool, device) -> list:
    win, pool = served(cell, seed, device, "auto")
    lengths = [r.length for r in win.requests]
    prompts = [pool[r.offset:r.offset + r.length] for r in win.requests]
    t = time.perf_counter()
    ref = main.reference_logits(cell.model, seed, prompts, device)
    out = [row(seed, "program", [r.logits for r in win.requests], ref,
               lengths, reference_s=time.perf_counter() - t,
               tokens=win.tokens)]
    if plain:
        witness, _ = served(cell, seed, device, "ref")
        out.append(row(seed, "plain_route",
                       [r.logits for r in witness.requests], ref, lengths))
        out.append(row(seed, "program_vs_plain_route",
                       [r.logits for r in win.requests],
                       [r.logits for r in witness.requests], lengths))
    if control:
        low = main.reference_logits(cell.model, seed, prompts, device, act_bits=4,
                                    weight_bits=4)
        out.append(row(seed, "control", [p.cpu() for p in low], ref,
                       lengths))
    return out


def cli(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--plain-seeds", default="",
                    help="seeds also served on the program's plain route")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    guard.pin_caches(spec.ROOT)
    cell = spec.load_cell(args.workload)
    device = guard.require_cards(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    plains = {int(s) for s in args.plain_seeds.split(",") if s}
    rows = []
    for seed in sorted(set(seeds) | controls | plains):
        for r in read_seed(cell, seed, seed in controls, seed in plains,
                           device):
            r["workload"] = cell.name
            print(json.dumps({k: v for k, v in r.items()
                              if k != "per_request"}), flush=True)
            rows.append(r)
    summary = {"workload": cell.name, "device": torch.cuda.get_device_name(),
               "power_limit": main.power_limit()}
    for side, pick in (("program", max), ("control", min)):
        got = [r for r in rows if r["side"] == side]
        for key in NUMBERS:
            if got:
                summary[f"{side}_{key}"] = pick(r[key] for r in got)
    print(json.dumps(summary), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows + [summary]:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
