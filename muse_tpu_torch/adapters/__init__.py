from .simple import SimpleMuseProblem

__all__ = ["SimpleMuseProblem"]
