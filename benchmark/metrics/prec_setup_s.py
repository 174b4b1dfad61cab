"""Seconds of the preconditioner's set-up: the sum of the built
`PaddedTwoLevelSchwarz`'s own `timings` (level-1 factor, GDSW coarse space,
coarse layout; each stopped after a synchronise)."""


def read(run):
    cache = run.system.mixed_cache() if run.system is not None else None
    prec = cache.get("prec") if cache else None
    timings = getattr(prec, "timings", None)
    return sum(timings.values()) if timings else None
