"""Checkpointing of the full training state, crash-consistently
(counterpart of ``d4pg_tpu/runtime/checkpoint.py``, with Orbax replaced by
``torch.save`` / ``torch.load``).

One checkpoint holds everything the learner's :class:`TrainState` carries:
the step, the four networks' ``state_dict``s and both Adam
``state_dict``s (``exp_avg``, ``exp_avg_sq`` and ``step``: optax's ``mu``,
``nu`` and ``count``), so ``--resume`` continues the same optimisation.
The trainers' generators are not saved: they re-seed them from ``--seed``
on every start, as the JAX trainer re-derives its megastep key. The two
generators saved are a REDQ ensemble's target-subset generator
(``TrainState.subset_gen``) and a pixel run's DrQ shift generator
(``TrainState.augment_gen``), the uses the JAX ``TrainState.key`` has
here: the JAX checkpoint carries that key, so a resumed run continues
both streams. The state's critic configuration (``TrainState.stack``: twin,
ensemble width, compute dtype) and its critic head (``TrainState.head``:
kind and mixture width) are saved too, and a restore into a state built
for another one raises :class:`StackMismatch` naming the field.

Layout: each step is a directory ``<directory>/<step>/state.pt``, written
into ``<step>.tmp/`` and renamed into place (Orbax's finalize-by-rename),
so a ``kill -9`` mid-save leaves no half-named step. The save is
synchronous.

**Crash consistency.** A checkpoint is several artifacts (the step
directory, ``trainer_meta.json``, optionally ``replay.npz`` and
``device_per.npz``). The commit record is a per-step manifest
(``manifest_<step>.json``, :mod:`d4pg_tpu_torch.runtime.manifest`) with
the digests of every file in the step directory and of the side files,
written LAST. :meth:`CheckpointManager.restore_verified` walks steps
newest to oldest and restores the newest intact one: a step whose
manifest is missing (a crash mid-save) or whose digests mismatch
(truncation, corruption), or whose load raises, is skipped with a logged
fallback. Side-file drift is warned about, not fatal.

The step directories are not the JAX package's (``state.pt`` is not an
Orbax checkpoint); the manifests, ``trainer_meta.json`` and
``best_eval.json`` are byte-compatible with it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from d4pg_tpu_torch.agent.state import HEAD_DEFAULTS, STACK_DEFAULTS, TrainState
from d4pg_tpu_torch.runtime import manifest as _manifest

STATE_FILE = "state.pt"
NETWORKS = ("actor", "critic", "target_actor", "target_critic")
OPTIMIZERS = ("actor_opt", "critic_opt")


class StackMismatch(ValueError):
    """A checkpoint of another critic configuration (twin, ensemble width,
    compute dtype, critic head) than the run that restores it. Not a torn file: the
    restore raises rather than fall back to an older step."""


def state_dict_of(state: TrainState) -> dict:
    """Everything one checkpoint saves: the step, every network's and every
    optimizer's ``state_dict``, the critic configuration and, with a REDQ
    ensemble, the subset generator's state, with pixels the shift
    generator's."""
    out = {"step": int(state.step), "stack": dict(state.stack), "head": dict(state.head)}
    for name in NETWORKS + OPTIMIZERS:
        out[name] = getattr(state, name).state_dict()
    if state.subset_gen is not None:
        out["subset_gen"] = state.subset_gen.get_state()
    if state.augment_gen is not None:
        out["augment_gen"] = state.augment_gen.get_state()
    return out


def check_stack(state: TrainState, saved: dict) -> None:
    """Raise :class:`StackMismatch` naming every field of the critic
    configuration where the checkpoint and the live state differ. A
    checkpoint written before the field existed is a single float32
    categorical critic."""
    diff = []
    for key, defaults, live in (("stack", STACK_DEFAULTS, state.stack),
                                ("head", HEAD_DEFAULTS, state.head)):
        was = {**defaults, **saved.get(key, {})}
        diff += [f"{k}={was[k]!r} in the checkpoint, {live[k]!r} in this run"
                 for k in defaults if was[k] != live[k]]
    if diff:
        raise StackMismatch(
            "checkpoint of another critic configuration: " + "; ".join(diff)
            + " — resume with the flags it was trained with (--twin-critic, "
            "--critic-ensemble, --compute-dtype, --critic-head, --num-mixtures) "
            "or use a fresh --log-dir"
        )


def _steps_on_cpu(opt: torch.optim.Optimizer) -> None:
    """Put each loaded ``step`` where torch keeps it for this optimizer.
    ``load_state_dict`` moves only the moments to the parameter's device;
    a non-capturable, non-fused Adam reads ``step`` on the host every
    update, so a ``step`` left on the card would make each update wait for
    the device."""
    for group in opt.param_groups:
        if group.get("capturable") or group.get("fused"):
            continue
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].cpu()


def load_state_into(state: TrainState, saved: dict) -> TrainState:
    """Load a :func:`state_dict_of` dict IN PLACE: the live modules and
    optimizers keep their identity (the optimizers keep their parameter
    references). Raises :class:`StackMismatch` before touching anything if
    the critic configurations differ."""
    check_stack(state, saved)
    for name in NETWORKS:
        getattr(state, name).load_state_dict(saved[name])
    for name in OPTIMIZERS:
        opt = getattr(state, name)
        opt.load_state_dict(saved[name])
        _steps_on_cpu(opt)
    if state.subset_gen is not None and "subset_gen" in saved:
        # map_location moved the saved ByteTensor; set_state takes it on the host
        state.subset_gen.set_state(saved["subset_gen"].cpu())
    if state.augment_gen is not None and "augment_gen" in saved:
        state.augment_gen.set_state(saved["augment_gen"].cpu())
    state.step = int(saved["step"])
    return state


def _device_of(state: TrainState) -> torch.device:
    return next(state.actor.parameters()).device


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list:
        """Every finalized step directory, ascending (``<step>.tmp`` is an
        unfinished save, not a step)."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(
            int(n) for n in names
            if n.isdigit() and os.path.isdir(os.path.join(self.directory, n))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        latest = self.latest_step()
        if latest is not None and step <= latest:
            if step == latest:
                # A re-save at the newest step (a preemption right after a
                # periodic save): those bytes already exist.
                return
            # A directory holding a NEWER step belongs to another run;
            # training on while no checkpoint ever lands is the failure
            # this refuses.
            raise RuntimeError(
                f"checkpoint save at step {step} refused: this directory "
                f"already holds a NEWER checkpoint (latest {latest}), so it "
                "belongs to another run — resume it with --resume, or use a "
                "fresh --log-dir"
            )
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)  # a crashed earlier attempt
        os.makedirs(tmp)
        torch.save(state_dict_of(state), os.path.join(tmp, STATE_FILE))
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def delete(self, step: int) -> None:
        """Remove one saved step and its manifest: an attestation must
        never outlive its bytes."""
        d = self.step_dir(step)
        if d is not None:
            shutil.rmtree(d, ignore_errors=True)
        try:
            os.remove(self.manifest_path(step))
        except FileNotFoundError:
            pass

    def restore(self, template: TrainState, step: Optional[int] = None) -> TrainState:
        """Load step ``step`` (default: the newest) IN PLACE into
        ``template`` and return it. Tensors load onto the template's
        device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = self.step_dir(step)
        if d is None:
            raise FileNotFoundError(f"no step {step} in {self.directory}")
        saved = torch.load(
            os.path.join(d, STATE_FILE), map_location=_device_of(template), weights_only=True
        )
        return load_state_into(template, saved)

    # ----------------------------------------------------- crash consistency
    def manifest_path(self, step: int) -> str:
        return _manifest.manifest_path(self.directory, step)

    def step_dir(self, step: int) -> Optional[str]:
        return _manifest.default_step_dir(self.directory, step)

    def write_manifest(self, step: int, side_files: Optional[list] = None) -> str:
        """Write the commit record for ``step``: digests of the finalized
        step directory plus the side files (absolute paths). MUST be called
        after the save and after the side files landed. Also prunes the
        manifests of steps garbage-collected by ``max_to_keep``."""
        step_dir = self.step_dir(step)
        if step_dir is None:
            raise FileNotFoundError(
                f"no step directory for step {step} under {self.directory}"
            )
        path = _manifest.write_manifest_file(
            self.manifest_path(step),
            _manifest.build_manifest(step, step_dir, side_files),
        )
        live = set(self.all_steps())
        for s in _manifest.manifest_steps(self.directory):
            if s not in live:
                try:
                    os.remove(self.manifest_path(s))
                except FileNotFoundError:
                    pass
        return path

    def load_manifest(self, step: int) -> Optional[dict]:
        return _manifest.load_manifest(self.directory, step)

    def verify_step(self, step: int) -> tuple:
        """``(ok, why, side_warnings)`` against the step's manifest."""
        return _manifest.verify_step_dir(self.directory, step, self.step_dir(step))

    def restore_verified(self, template: TrainState) -> tuple:
        """Restore the newest INTACT step: ``(state, step, fallbacks)``.

        Walks steps newest to oldest; skips a step whose manifest is
        missing or mismatched, and a step whose load raises. ``fallbacks``
        lists one reason per skipped step. A run with no manifest for ANY
        step restores newest-first. Every skipped newer step is pruned, so
        the resumed run's next save there does not collide with it."""
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        attested_any = any(os.path.exists(self.manifest_path(s)) for s in steps)
        fallbacks = []
        for step in steps:
            if attested_any:
                ok, why, warnings = self.verify_step(step)
                if not ok:
                    fallbacks.append(f"step {step}: {why}")
                    continue
                for w in warnings:
                    print(f"[checkpoint] step {step}: {w}")
            try:
                state = self.restore(template, step)
            except (FileNotFoundError, StackMismatch):
                raise
            except Exception as e:
                # torch.load and load_state_dict raise many types on a torn
                # or foreign file; any of them means "not intact". A later
                # step's load overwrites every tensor a failed one touched.
                fallbacks.append(f"step {step}: restore failed: {e!r}")
                print(f"[checkpoint] step {step} failed to restore ({e!r}); falling back")
                continue
            for bad in [s for s in steps if s > step]:
                print(f"[checkpoint] pruning non-intact step {bad}")
                self.delete(bad)
            return state, step, fallbacks
        raise RuntimeError(
            f"no intact checkpoint under {self.directory}: " + "; ".join(fallbacks)
        )


def trainer_meta_path(log_dir: str) -> str:
    return os.path.join(log_dir, "checkpoints", "trainer_meta.json")


def save_trainer_meta(log_dir: str, env_steps: int, ewma_return, extra=None) -> None:
    """Atomically persist the host-side counters the TrainState does not
    carry (env_steps drives the noise schedule; the EWMA keeps curves
    continuous). The file is the JAX package's byte for byte."""
    path = trainer_meta_path(log_dir)
    tmp = path + ".tmp"
    meta = {"env_steps": env_steps, "ewma_return": ewma_return}
    if extra:
        meta.update(extra)
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path)


def best_eval_path(log_dir: str) -> str:
    return os.path.join(log_dir, "best_eval.json")


def save_best_eval(log_dir: str, step: int, score: float, env_steps: int) -> None:
    """Atomically record the keep-best score. Callers persist the params
    FIRST: a crash never leaves the JSON claiming params never saved."""
    path = best_eval_path(log_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "eval_return_mean": score, "env_steps": env_steps}, f)
    os.replace(tmp, path)


def invalidate_best_eval(log_dir: str) -> None:
    """Remove the keep-best attestation before mutating the params it
    points at: after a crash mid-replacement the consistent state is "no
    best recorded"."""
    try:
        os.remove(best_eval_path(log_dir))
    except FileNotFoundError:
        pass


def load_trainer_meta(log_dir: str) -> dict:
    """The resume-side counters, or ``{}`` when the file is absent or does
    not parse: resume degrades to fresh counters instead of dying."""
    path = trainer_meta_path(log_dir)
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (ValueError, OSError) as e:
        print(
            f"[checkpoint] {path} is unreadable/corrupt ({e}); treating "
            "trainer meta as missing — env-step counters restart fresh"
        )
        return {}
