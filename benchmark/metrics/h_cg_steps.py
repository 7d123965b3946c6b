"""Implicit H's HVP-CG steps a pipeline: the change of
``batched_cg.steps`` over the ``h_implicit_from_whites`` calls
(``solver/compiled.py``, ``ops/cg.py``). Nothing where the program keeps
no such counter."""


def read(t):
    steps = [x for p in t["pipelines"] for x in p["steps"]
             if x["name"] == "h_implicit_from_whites"]
    if not t["pipelines"] or not steps or \
            any("h_cg_steps" not in x for x in steps):
        return None
    return sum(x["h_cg_steps"] for x in steps) / len(t["pipelines"])
