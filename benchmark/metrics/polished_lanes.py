"""Lanes handed to VarPro's Newton-CG polish a pipeline, in the fit and in
H's fiducial solve: the change of ``zhat_varpro.polished_lanes`` over the
step calls (``models/lensing.py``). Nothing where the program keeps no
such counter."""


def read(t):
    steps = [x for p in t["pipelines"] for x in p["steps"]
             if x["name"] != "sample_whites"]
    if not t["pipelines"] or not steps or \
            any("polished_lanes" not in x for x in steps):
        return None
    return sum(x["polished_lanes"] for x in steps) / len(t["pipelines"])
