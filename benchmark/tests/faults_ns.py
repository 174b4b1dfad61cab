"""The faults of `faults.py` and `faults_vector.py` for the cavity cell
(operation `jacobian_solves`): an answer altered where it is produced, a
steady state altered where Newton returns it, and the program's own
answers stored in float32 (what the storage precision alone costs):

    python3 -m benchmark.tests.faults_ns <fault> --workload <cell> \\
        --seed <n> --seconds <s> --trace 0 [--rehearse]

runs `benchmark.run` through `faults.main` with these faults added.
"""

from __future__ import annotations

import sys

from benchmark.tests import faults, faults_vector

FAULTS = {
    "altered_answer": {"jacobian_solves": faults.altered_answer},
    "altered_state": {"jacobian_solves": faults.altered_state},
    "rounded_f32": {"jacobian_solves": faults_vector.rounded_f32},
}


def main(argv=None) -> int:
    for fault, plants in FAULTS.items():
        faults.FAULTS.setdefault(fault, {}).update(plants)
    return faults.main(argv)


if __name__ == "__main__":
    sys.exit(main())
