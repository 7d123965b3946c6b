"""Synchronised wall of one outer iteration's step calls, every chunk of
lanes summed (``CompiledProblem.muse_step_white``), mean over iterations."""


def read(t):
    its = sum(p["iterations"] for p in t["pipelines"])
    if not its:
        return None
    s = sum(x["seconds"] for p in t["pipelines"] for x in p["steps"]
            if x["fit"])
    return 1000.0 * s / its
