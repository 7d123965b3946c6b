"""Share of a pipeline's wall spent outside the program's step calls: the
host θ loop, the problem build, J and H's host work (``solver/muse.py``,
``solver/jacobians.py``, ``solver/covariance.py``)."""


def read(t):
    wall = sum(p["wall"] for p in t["pipelines"])
    if not wall:
        return None
    steps = sum(s["seconds"] for p in t["pipelines"] for s in p["steps"])
    return 100.0 * (wall - steps) / wall
