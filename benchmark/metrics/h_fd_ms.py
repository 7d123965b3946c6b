"""Synchronised wall of finite-difference H a pipeline: the
``h_fiducial`` and ``h_fd`` step calls (``CompiledProblem``), mean over the
timed pipelines. Nothing where a pipeline makes no such call."""

NAMES = ("h_fiducial", "h_fd")


def read(t):
    steps = [x for p in t["pipelines"] for x in p["steps"]
             if x["name"] in NAMES]
    if not t["pipelines"] or not steps:
        return None
    return 1000.0 * sum(x["seconds"] for x in steps) / len(t["pipelines"])
