"""VarPro's inner elimination-PCG steps an outer iteration, every chunk
summed: the change of ``batched_varpro.inner_steps`` over the fit's step
calls (``ops/varpro.py``)."""


def read(t):
    its = sum(p["iterations"] for p in t["pipelines"])
    if not its:
        return None
    return sum(x["cg_steps"] for p in t["pipelines"] for x in p["steps"]
               if x["fit"]) / its
