"""Pure annealing schedules (the port's own copy of
``d4pg_tpu/replay/schedules.py``).

Reference ``LinearSchedule`` (``prioritized_replay_memory.py:5-29``) mutates
an internal counter on every ``value()`` call (SURVEY.md quirk #8); here the
schedule is a pure function of the learner step, so it is reproducible,
checkpoint-friendly, and usable inside jit.
"""

from __future__ import annotations


def linear_schedule(step: int, total_steps: int, start: float, end: float) -> float:
    """Linear interpolation start→end over total_steps, clamped after."""
    frac = min(max(float(step) / max(total_steps, 1), 0.0), 1.0)
    return start + frac * (end - start)


def noise_scale_schedule(env_steps: int, decay_steps: int, final: float) -> float:
    """Exploration-noise scale at env_steps: 1→final over decay_steps;
    constant 1.0 when decay_steps <= 0 (the reference's effective behavior,
    SURVEY.md quirk #10)."""
    if decay_steps <= 0:
        return 1.0
    return linear_schedule(env_steps, decay_steps, 1.0, final)
