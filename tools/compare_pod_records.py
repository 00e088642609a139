"""Compare two directories of dry-run records cell by cell.

The records are the JSON files ``python -m repro_torch.launch.dryrun``
writes (``--out DIR``), for instance one directory counted under each of
two torch versions.  For every cell in both, prints whether the
statuses, the collectives (bytes and counts by kind), the products
(FLOPs of the int8, bf16 and fp32_dot classes) and the whole record
(``compile_s`` and ``torch`` aside) are equal, and how far
``bytes_accessed`` and the roofline step time of the second directory
are from the first's, then a tally.

  python tools/compare_pod_records.py DIR_A DIR_B
"""

from __future__ import annotations

import collections
import glob
import json
import os
import sys

PRODUCTS = ("int8", "bf16", "fp32_dot")
IGNORED = ("compile_s", "torch")


def compare(a: dict, b: dict) -> dict:
    """The comparison of one cell's two ``ok`` records."""
    sa, sb = a["stats"], b["stats"]
    kinds = ("collective_bytes_by_kind", "collective_count_by_kind")
    return {
        "collectives": all(sa[k] == sb[k] for k in kinds),
        "products": all(sa["flops_by_class"][c] == sb["flops_by_class"][c]
                        for c in PRODUCTS),
        "record": ({k: v for k, v in a.items() if k not in IGNORED}
                   == {k: v for k, v in b.items() if k not in IGNORED}),
        "bytes_rel": sb["bytes_accessed"] / sa["bytes_accessed"] - 1,
        "step_rel": (b["roofline"]["step_time_s"]
                     / a["roofline"]["step_time_s"] - 1),
    }


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    tally = collections.Counter()
    worst = {"bytes_rel": 0.0, "step_rel": 0.0}
    for path in sorted(glob.glob(os.path.join(argv[0], "*.json"))):
        other = os.path.join(argv[1], os.path.basename(path))
        if not os.path.exists(other):
            continue
        with open(path) as f:
            a = json.load(f)
        with open(other) as f:
            b = json.load(f)
        name = os.path.basename(path)[:-len(".json")]
        tally[f"status {a['status']} / {b['status']}"] += 1
        if a["status"] != "ok" or b["status"] != "ok":
            continue
        c = compare(a, b)
        for k in ("collectives", "products", "record"):
            tally[f"{k} {'equal' if c[k] else 'differ'}"] += 1
        for k in worst:
            if abs(c[k]) > abs(worst[k]):
                worst[k] = c[k]
        print(f"{name}: collectives {c['collectives']}, products "
              f"{c['products']}, record {c['record']}, bytes "
              f"{c['bytes_rel']:+.4%}, step {c['step_rel']:+.4%}")
    for k, n in sorted(tally.items()):
        print(f"{k}: {n}")
    print(f"largest bytes_accessed difference {worst['bytes_rel']:+.4%}, "
          f"step time {worst['step_rel']:+.4%}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
