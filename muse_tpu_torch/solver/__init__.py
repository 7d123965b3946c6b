from .muse import muse, muse_fit
from .jacobians import get_J, get_H
from .compiled import CompiledProblem

__all__ = ["muse", "muse_fit", "get_J", "get_H", "CompiledProblem"]
