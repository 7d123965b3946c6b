"""PCG steps an outer iteration takes, every chunk summed: the change of
``batched_cg.curvature_steps`` over the fit's step calls (``ops/cg.py``)."""


def read(t):
    its = sum(p["iterations"] for p in t["pipelines"])
    if not its:
        return None
    return sum(x["cg_steps"] for p in t["pipelines"] for x in p["steps"]
               if x["fit"]) / its
