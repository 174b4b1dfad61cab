"""Operation `vector_solve_stream`: the loop and check of `solve_stream`
for a vector field (a load kind of nodal 3-vectors, such as
`vector_modes_plus_noise`), through the same `LinearSolver.solve_system`.
It is an operation of its own only so that the faults of `tests/faults.py`,
whose float32 control is the scalar Laplace solve of the P1 solve cell,
are not planted in a vector cell: the vector cells' faults and their own
float32 control are planted by `tests/test_harness_elasticity.py`."""

from __future__ import annotations

from benchmark import plugins


class Loop(plugins.load("operations", "solve_stream").Loop):
    pass
