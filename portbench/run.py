"""Run one cell of BENCHMARK.json once on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the numbers compared with the reference, each beside its limit,
as the last lines of standard error, and one JSON object as the last
line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``check`` last.  Exits 2 without a result where there is no card, or
where the checkout holds no program; 3 where the process holds JAX or
the JAX package once the window has closed.
"""

import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the checkout's root (for ``portbench``) and ``src`` (for the program),
# in place of this script's own directory, whose folders are no modules
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from portbench.harness.main import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:], T0))
