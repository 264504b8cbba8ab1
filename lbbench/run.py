"""Run one cell of the lb2d_tpu_torch benchmark once, on the card.

    python3 lbbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard
error). Exits with another code than 0, and prints no result, without a
CUDA device, with fewer than the cell asks for, or where the JAX package
or JAX was loaded in this process.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from lbbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
