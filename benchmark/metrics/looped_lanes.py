"""Lanes the keyed route drew one generator at a time an outer iteration,
every chunk summed: the change of ``sample_batch.looped_lanes`` over the
fit's step calls (``CompiledProblem._sample_batch``, ``solver/compiled.py``).
Nothing where the program keeps no such counter."""


def read(t):
    its = sum(p["iterations"] for p in t["pipelines"])
    steps = [x for p in t["pipelines"] for x in p["steps"] if x["fit"]]
    if not its or not steps or any("looped_lanes" not in x for x in steps):
        return None
    return sum(x["looped_lanes"] for x in steps) / its
