"""dm_control suite adapter, state or pixel observations (the port's own
copy of ``d4pg_tpu/envs/dmc_adapter.py``).

Puts any ``dm_control.suite`` task behind the same host-env interface as
:class:`~d4pg_tpu_torch.envs.gym_adapter.GymAdapter` (reset() → obs,
step(a) → (obs, r, terminated, truncated, info), canonical (−1,1)
actions), so the trainer, the actor pool and the evaluator drive it
unchanged.

State mode (``dmc:domain:task``) concatenates the suite's observation
dict. Pixel mode (``dmc_pixels:domain:task``) follows the repo's pixel
convention: FLATTENED [H, W, 2] float frames in [0, 1], grayscale current
and previous frame, and the env advertises ``pixel_shape``. Rendering uses
MuJoCo's EGL backend when libEGL loads (:func:`_egl_loadable`), and
``MUJOCO_GL=disabled`` otherwise, where state mode still runs and pixel
mode raises. Several pixel adapters rendering concurrently from separate
processes deadlock inside ``eglMakeCurrent`` on a software GL stack, so
the trainer refuses pooled or asynchronous collection for them. Pixel mode
renders with shadows, multisampling and reflections off.

dm_control tasks never terminate; episodes end by time limit only,
reported as truncation (as gym's ``TimeLimit`` reports it). Neither
dm_control nor mujoco is on the H100's machine.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from d4pg_tpu_torch.envs.gym_adapter import NormalizeAction

# Categorical support for suite tasks: rewards are in [0, 1] per step, so
# values are bounded by the episode horizon. Exposed as adapter v_min/v_max
# attributes, which reconcile_config adopts for envs without a preset.
DMC_VALUE_RANGE = (0.0, 1000.0)


def _egl_loadable() -> bool:
    """Can this process load libEGL at all? dm_control imports its renderer
    AT IMPORT TIME, so with ``MUJOCO_GL=egl`` on an image without a GL
    stack even state-mode (never-rendering) envs die inside
    ``OpenGL.raw.EGL``. A cheap dlopen probe decides before the import
    commits."""
    import ctypes
    import ctypes.util

    try:
        ctypes.CDLL(ctypes.util.find_library("EGL") or "libEGL.so.1")
        return True
    except OSError:
        return False


def _load_suite():
    # An explicit MUJOCO_GL always wins (the probe only picks the default):
    # EGL when loadable — pixel rendering works and state mode is
    # unaffected; otherwise "disabled" — dm_control imports with
    # Renderer=None, state-mode physics runs fine, and pixel mode raises a
    # clear error below instead of an AttributeError five frames deep in
    # PyOpenGL.
    if "MUJOCO_GL" not in os.environ:
        os.environ["MUJOCO_GL"] = "egl" if _egl_loadable() else "disabled"
    from dm_control import suite

    return suite


class DMControlAdapter:
    """``dmc:domain:task`` (state) / ``dmc_pixels:domain:task`` (pixels)."""

    def __init__(
        self,
        domain: str,
        task: str,
        max_episode_steps: Optional[int] = None,
        pixels: bool = False,
        size: int = 48,
        camera_id: int = 0,
        action_repeat: int = 1,
    ):
        suite = _load_suite()
        self.env = suite.load(domain, task)
        self._dt = (domain, task)
        if action_repeat < 1:
            raise ValueError(f"action_repeat must be >= 1, got {action_repeat}")
        # DrQ convention (Kostrikov et al. 2020, §4 implementation details):
        # one agent step applies the action for `action_repeat` control
        # steps, summing the rewards; rendering happens once per AGENT step,
        # so in pixel mode the 2-frame stack spans the repeat interval —
        # exactly the velocity baseline published DrQ uses (repeat 4 for
        # cartpole swingup). Episode returns keep their [0, horizon] scale
        # because rewards are summed, not sampled.
        self.action_repeat = action_repeat
        # Categorical support hint for reconcile_config (no static preset
        # can enumerate every suite task; [0, horizon] bounds them all).
        self.v_min, self.v_max = DMC_VALUE_RANGE
        # Host-env marker: the Trainer routes envs with this attribute
        # through the host-collection paths (same convention as GymAdapter);
        # suite tasks are not goal-conditioned so it stays None.
        self.last_goal_obs = None
        self.pixels = pixels
        self.size = size
        self.camera_id = camera_id
        # suite episodes are time_limit/control_timestep steps long
        try:
            native_limit = int(round(
                self.env._time_limit / self.env.control_timestep()
            ))
        except (AttributeError, TypeError, OverflowError):
            native_limit = 1000  # suite default horizon
        # Horizon counts AGENT steps: repeat divides it so an episode still
        # covers the same simulated time (1000 frames @ repeat 4 → 250).
        self.max_episode_steps = max_episode_steps or max(
            1, native_limit // action_repeat
        )
        spec = self.env.action_spec()
        self._normalize = NormalizeAction(spec.minimum, spec.maximum)
        self.action_dim = int(np.prod(spec.shape))
        self._render_kwargs = {}
        if pixels:
            if os.environ.get("MUJOCO_GL") == "disabled":
                raise RuntimeError(
                    "dmc_pixels needs a working GL backend, but MUJOCO_GL="
                    "disabled (either set explicitly, or chosen by the "
                    "EGL-availability probe on an image without libEGL); "
                    "state-mode dmc: envs still work"
                )
            self.pixel_shape = (size, size, 2)
            self.observation_dim = size * size * 2
            # On a software GL stack (llvmpipe) MuJoCo's default shadow
            # pass + MSAA resolve are a fixed cost per render that dwarfs
            # a 48×48 frame; a grayscale RL observation carries no useful
            # shadow signal, and published DrQ renders flat too.
            vis = self.env.physics.model.vis
            vis.quality.shadowsize = 0
            vis.quality.offsamples = 0
            self._render_kwargs = dict(
                render_flag_overrides=dict(
                    shadow=False, reflection=False, skybox=False, haze=False
                )
            )
        else:
            self.observation_dim = int(
                sum(
                    np.prod(v.shape) if v.shape else 1
                    for v in self.env.observation_spec().values()
                )
            )
        self._prev_frame: Optional[np.ndarray] = None
        self._t = 0

    # ------------------------------------------------------------------ obs
    def _render_gray(self) -> np.ndarray:
        rgb = self.env.physics.render(
            height=self.size,
            width=self.size,
            camera_id=self.camera_id,
            **self._render_kwargs,
        )
        return (rgb.astype(np.float32) / 255.0).mean(axis=-1)

    def _obs(self, time_step) -> np.ndarray:
        if self.pixels:
            frame = self._render_gray()
            prev = frame if self._prev_frame is None else self._prev_frame
            self._prev_frame = frame
            return np.stack([frame, prev], axis=-1).ravel().astype(np.float32)
        return np.concatenate(
            [np.ravel(v) for v in time_step.observation.values()]
        ).astype(np.float32)

    # ------------------------------------------------------------- protocol
    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            # Reseed the EXISTING task RNG. Rebuilding via suite.load would
            # recompile the MJCF and (in pixel mode) open a fresh EGL
            # context per episode — the actor pool seeds every episode, so
            # that leaked a GL context and paid a model compile per episode.
            self.env.task._random = np.random.RandomState(seed)
        self._prev_frame = None
        self._t = 0
        return self._obs(self.env.reset())

    def _domain_task(self):
        return self._dt

    def step(self, action: np.ndarray):
        env_action = self._normalize.to_env(np.asarray(action))
        reward = 0.0
        for _ in range(self.action_repeat):
            ts = self.env.step(env_action)
            reward += float(ts.reward or 0.0)
            if ts.last():
                break  # don't step past an episode boundary mid-repeat
        self._t += 1
        # Standard suite tasks end by time limit only, but dm_control marks
        # a TRUE termination (early task end, physics divergence) with
        # ts.last() and discount == 0 — bootstrapping through that state
        # would corrupt the Bellman target, so distinguish the two
        # (dm_control environment.py TimeStep semantics).
        last = bool(ts.last())
        terminated = last and float(ts.discount or 0.0) == 0.0
        truncated = (last and not terminated) or self._t >= self.max_episode_steps
        return self._obs(ts), reward, terminated, truncated, {}

    def close(self):
        # Shutdown-only guard: dm_control's EGL renderer binds its GL
        # context to the first thread that rendered (here, the concurrent
        # evaluator thread); closing from another thread raises
        # EGL_BAD_ACCESS out of eglMakeCurrent. The process is exiting —
        # leak the context rather than crash the shutdown path.
        try:
            self.env.close()
        except Exception as e:
            # Only the known leak paths are swallowed: the cross-thread
            # EGL_BAD_ACCESS case (message carries "EGL"/"egl") and closes
            # during interpreter shutdown. Anything else is a genuine close
            # failure and propagates.
            import sys

            if "egl" in str(e).lower() or sys.is_finalizing():
                print(
                    f"[dmc_adapter] close() leaked GL context "
                    f"({type(e).__name__}: {e})"
                )
            else:
                raise


def make_dmc(
    name: str,
    max_episode_steps: Optional[int] = None,
    action_repeat: int = 1,
):
    """Parse ``dmc:domain:task`` / ``dmc_pixels:domain:task`` into an adapter."""
    parts = name.split(":", 2)
    if len(parts) != 3 or not all(parts):
        raise ValueError(
            f"bad dm_control env id {name!r}: expected dmc:<domain>:<task> "
            "or dmc_pixels:<domain>:<task> (e.g. dmc:cartpole:swingup)"
        )
    prefix, domain, task = parts
    return DMControlAdapter(
        domain,
        task,
        max_episode_steps=max_episode_steps,
        pixels=(prefix == "dmc_pixels"),
        action_repeat=action_repeat,
    )
