"""MuseResult — mutable accumulator enabling checkpoint/resume.

Counterpart of ``muse_tpu/result.py`` (the reference's ``MuseResult``,
``src/muse.jl:29-59``): holds the
estimate θ, the H and J matrices, the covariance Σ and its inverse, a
convenience Gaussian ``dist``, per-iteration ``history`` diagnostics, the
per-sim score sims ``gs`` (J) and jacobian sims ``Hs`` (H), free-form
``metadata``, the master seed (so resumed runs reuse identical sims), and
cumulative wall ``time``.  Resume semantics match the reference:

  * ``muse_fit`` continues from ``len(result.history)`` (src/muse.jl:159);
  * ``get_J``/``get_H`` are incremental — raising ``nsims`` adds only the
    missing sims (src/muse.jl:317-319,499-506);
  * the whole result pickles to disk after every outer iteration when
    ``checkpoint_file`` is given (src/muse.jl:234).
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["MuseResult", "load_result"]


@dataclasses.dataclass
class MuseResult:
    theta: Any = None            # flat np.ndarray (internal) — see .theta_user
    H: Optional[np.ndarray] = None
    J: Optional[np.ndarray] = None
    Sigma_inv: Optional[np.ndarray] = None
    Sigma: Optional[np.ndarray] = None
    dist: Any = None             # distributions.{Normal,MvNormal}
    history: List[Dict] = dataclasses.field(default_factory=list)
    gs: List[np.ndarray] = dataclasses.field(default_factory=list)
    Hs: List[np.ndarray] = dataclasses.field(default_factory=list)
    metadata: Dict = dataclasses.field(default_factory=dict)
    key: Any = None              # master seed of the sims (``rng`` analog)
    time: float = 0.0            # cumulative seconds
    # user-structured θ example (scalar/dict/pytree of numpy) — lets a
    # loaded result rebuild its ThetaSpec so resume preserves θ structure
    theta_struct: Any = None
    # θ structure bookkeeping (ComponentArrays-label analog); set by solver.
    theta_names: tuple = ()
    _spec: Any = None            # ThetaSpec (not required after load)

    # -------------------------------------------------------------- #

    @property
    def theta_user(self):
        """θ in the user's original structure (dict/scalar/pytree)."""
        if self.theta is None or self._spec is None:
            return self.theta
        return self._spec.to_user(self.theta)

    @property
    def sigma(self):
        """Per-component standard deviations (None before get_J/get_H):
        the MUSE sandwich √diag((HᵀJ⁻¹H + H_prior)⁻¹). Where the data
        barely constrain a θ component, J ≫ H is genuine and σ is
        conservative; the J/H-ratio warning of finalize_result flags it."""
        if self.Sigma is None:
            return None
        S = np.atleast_2d(np.asarray(self.Sigma))
        return np.sqrt(np.diag(S))

    def __repr__(self):
        # μ±σ pretty printing (src/muse.jl:45-59)
        if self.theta is None:
            return "MuseResult()"
        th = np.atleast_1d(np.asarray(self.theta))
        names = self.theta_names or tuple(f"θ[{i}]" for i in range(th.size))
        if self.Sigma is not None:
            sig = self.sigma
            parts = [f"{n}={m:.4g}±{s:.3g}" for n, m, s in zip(names, th, sig)]
        else:
            parts = [f"{n}={m:.4g}" for n, m in zip(names, th)]
        return "MuseResult(" + ", ".join(parts) + ")"

    # ----------------------- checkpointing ------------------------ #

    def save(self, filename: str):
        # shallow per-field state (dataclasses.asdict would deep-convert
        # the nested frozen-dataclass ``dist`` into a plain dict with no
        # sample/log_prob); dist is dropped and rebuilt on load from
        # θ̂/Σ, exactly as finalize_result builds it
        state = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self)}
        state.pop("_spec")           # closures don't pickle; rebuilt by solver
        state["dist"] = None
        state = _to_numpy(state)
        with open(filename, "wb") as f:
            pickle.dump(state, f)

    @classmethod
    def load(cls, filename: str) -> "MuseResult":
        with open(filename, "rb") as f:
            state = pickle.load(f)
        state.pop("dist", None)
        res = cls(**state, _spec=None)
        if res.Sigma is not None and res.theta is not None:
            from .distributions import MvNormal, Normal
            th = np.atleast_1d(np.asarray(res.theta, np.float64))
            S = np.atleast_2d(np.asarray(res.Sigma, np.float64))
            if th.size == 1:
                res.dist = Normal(float(th[0]), float(np.sqrt(S[0, 0])))
            else:
                res.dist = MvNormal(th, 0.5 * (S + S.T))
        return res


def _to_numpy(obj):
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_to_numpy(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if hasattr(obj, "__array__"):
        return np.asarray(obj)
    return obj


def load_result(filename: str) -> MuseResult:
    return MuseResult.load(filename)
