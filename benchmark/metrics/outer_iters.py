"""Outer iterations of a fit (``len(result.history)``), mean over the
traced pipelines."""


def read(t):
    its = [p["iterations"] for p in t["pipelines"]]
    return sum(its) / len(its) if its else None
