"""The off-policy promotion gate: importance-weighted return estimation
(the port's copy of ``d4pg_tpu/flywheel/gate.py``: the same float64
arithmetic, the same clip and the same verdict dicts).

A router's canary observes what live traffic shows, error rate and tail
latency. A bad but valid bundle shows neither: it serves cleanly while
steering the plant off a cliff. This gate estimates the CANDIDATE
bundle's return on the windows the mirror tap logged from live serving
traffic, without routing a live request to it.

The estimator (self-normalized importance sampling over each window's
first decision, mirror windows being n-step collapsed already)::

    ρ_i = exp( log π_cand(a_i | s_i) − log μ(a_i | s_i) )
    V̂_cand = Σ ρ_i R_i / Σ ρ_i          V̂_behavior = mean(R_i)
    ESS = (Σ ρ_i)² / Σ ρ_i²

where ``a_i`` is the EXECUTED first action of mirrored window ``i``,
``log μ`` the behavior log-prob the client logged when it acted (it
rides the mirror frame), ``R_i`` the window's n-step return, and
``log π_cand`` computed here with the torch-free numpy bundle policy
(``fleet/policy.py:NumpyPolicy``): the candidate acts at μ_cand(s) and
the client adds Gaussian noise σ, so ``π_cand = N(μ_cand(s), σ²)``, the
family the behavior propensity was logged under.

Decision table: promote iff

    samples ≥ min_windows        (a starved gate never guesses)
    ESS     ≥ min_ess            (weights on a handful of windows make
                                  the estimate noise, and a candidate far
                                  off the serving distribution shows
                                  exactly this)
    V̂_cand  ≥ V̂_behavior − band  (the candidate must not score much
                                  below what the serving bundle earns)

Log-ratios are clipped from ABOVE at :data:`CLIP_LOG_RHO` before the
exponential: one extreme weight must lower the ESS (and fail the gate),
not overflow. They are NOT clipped from below: a lower clip would flatten
the near-zero weights of a far-off candidate into equal tiny values,
which restores full ESS and reduces the estimate to the behavior mean,
waving exactly the wrong bundle through. Underflow to 0 is the right
answer for a window the candidate would never have produced; if every
weight underflows, the gate refuses.

numpy and the stdlib only.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

CLIP_LOG_RHO = 20.0


def gaussian_log_prob(action: np.ndarray, mean: np.ndarray, sigma: float) -> np.ndarray:
    """Row-wise log N(action; mean, σ²I) over the action dimensions, in
    float64: the propensity formula the sim client logs behavior with and
    the gate weights the candidate with (one expression, two callers)."""
    action = np.asarray(action, np.float64)
    mean = np.asarray(mean, np.float64)
    sigma = float(sigma)
    d = action.shape[-1]
    quad = np.sum((action - mean) ** 2, axis=-1) / (2.0 * sigma**2)
    return -quad - d * (math.log(sigma) + 0.5 * math.log(2.0 * math.pi))


def evaluate_is_gate(
    cols: dict,
    candidate_policy,
    *,
    sigma: float,
    min_windows: int = 16,
    min_ess: float = 4.0,
    band: float = 1.0,
    max_windows: Optional[int] = None,
) -> dict:
    """One gate verdict over mirrored windows.

    ``cols`` is the spool's column dict (obs / action / reward / logprob,
    float32, :func:`~d4pg_tpu_torch.flywheel.spool.read_windows`);
    ``candidate_policy`` anything with ``act(obs [N, obs_dim]) → [N,
    action_dim]``. Returns the verdict dict: ``samples``, ``sigma``,
    ``min_windows``, ``min_ess``, ``band``, ``ess``, ``v_behavior``,
    ``v_candidate``, ``passed`` and ``reason``.
    """
    n = int(len(cols.get("reward", ()))) if cols else 0
    if max_windows is not None and n > max_windows:
        cols = {k: v[-max_windows:] for k, v in cols.items()}
        n = max_windows
    verdict = {
        "samples": n,
        "sigma": float(sigma),
        "min_windows": int(min_windows),
        "min_ess": float(min_ess),
        "band": float(band),
    }
    if n < min_windows:
        verdict.update(
            ess=0.0, v_behavior=0.0, v_candidate=0.0, passed=False,
            reason=f"starved: {n} mirrored windows < {min_windows}",
        )
        return verdict
    mean = candidate_policy.act(np.asarray(cols["obs"], np.float32))
    logp_cand = gaussian_log_prob(cols["action"], mean, sigma)
    # upper clip only (the module docstring says why not a lower one)
    log_rho = np.minimum(logp_cand - np.asarray(cols["logprob"], np.float64), CLIP_LOG_RHO)
    rho = np.exp(log_rho)
    wsum = float(rho.sum())
    reward = np.asarray(cols["reward"], np.float64)
    v_beh = float(reward.mean())
    if wsum <= 0.0:
        # every weight underflowed: the candidate would produce none of
        # the served actions
        verdict.update(
            ess=0.0, v_behavior=round(v_beh, 4), v_candidate=0.0, passed=False,
            reason=(
                "effective sample size 0.00: candidate acts far off the "
                "serving distribution"
            ),
        )
        return verdict
    ess = float(wsum**2 / float((rho**2).sum()))
    v_cand = float((rho * reward).sum() / wsum)
    verdict.update(ess=round(ess, 3), v_behavior=round(v_beh, 4), v_candidate=round(v_cand, 4))
    if ess < min_ess:
        verdict.update(
            passed=False,
            reason=(
                f"effective sample size {ess:.2f} < {min_ess:g}: candidate "
                "acts far off the serving distribution"
            ),
        )
        return verdict
    if v_cand < v_beh - band:
        verdict.update(
            passed=False,
            reason=f"IS return estimate {v_cand:.3f} below behavior {v_beh:.3f} − band {band:g}",
        )
        return verdict
    verdict.update(passed=True, reason="ok")
    return verdict
