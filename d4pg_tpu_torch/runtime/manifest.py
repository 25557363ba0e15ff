"""Checkpoint commit-record (manifest) primitives (the port's own copy of
``d4pg_tpu/runtime/manifest.py``; the logic is the same line for line,
except that a step directory is looked for only at ``<ckpt_dir>/<step>``,
the one layout the port writes).

The crash-consistency contract (``runtime/checkpoint.py``) is: a
checkpoint is several artifacts, and a per-step ``manifest_<step>.json``
— content digests of every file in the step directory plus the side
files — written LAST is the commit record. This module is the pure half
of that contract: hashing, manifest build/load, digest verification,
newest-intact-step discovery, and verified checkpoint forking. Its files
are the JAX package's byte for byte, so either package verifies the
other's manifests.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import List, Optional, Tuple

MANIFEST_PREFIX = "manifest_"

# Side files (trainer_meta.json, replay.npz) above this size are recorded
# size-only in the manifest: their mismatch is warn-only at restore, so a
# full read-back of a multi-GB replay snapshot per checkpoint would buy a
# log line at real learner-stall cost. Step-directory files (which GATE the
# restore) are always content-hashed.
SIDE_DIGEST_MAX_BYTES = 16 << 20


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def dir_digests(root: str) -> dict:
    """``relpath -> {sha256, size}`` for every file under ``root``,
    deterministic order."""
    out: dict = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, root).replace(os.sep, "/")
            out[rel] = {"sha256": sha256_file(p), "size": os.path.getsize(p)}
    return out


def manifest_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{MANIFEST_PREFIX}{step}.json")


def manifest_steps(ckpt_dir: str) -> List[int]:
    """Every step with a manifest file under ``ckpt_dir``, ascending."""
    steps = []
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return steps
    for name in names:
        if name.startswith(MANIFEST_PREFIX) and name.endswith(".json"):
            try:
                steps.append(int(name[len(MANIFEST_PREFIX):-len(".json")]))
            except ValueError:
                continue
    return sorted(steps)


def build_manifest(step: int, step_dir: str,
                   side_files: Optional[list] = None) -> dict:
    """The commit-record document for one finalized step directory +
    side files (absolute paths; digested under a separate key — mismatch
    there is drift, not corruption). Callers write it ATOMICALLY and
    LAST (:func:`write_manifest_file`)."""
    manifest = {"step": step, "files": dir_digests(step_dir), "side": {}}
    for p in side_files or []:
        if os.path.exists(p):
            size = os.path.getsize(p)
            entry = {"size": size}
            # Side mismatches are warn-only at restore (drift, not
            # corruption), so a full read-back of a multi-GB replay
            # snapshot per save buys nothing — hash only small side
            # files (the meta), record size alone for the big ones.
            if size <= SIDE_DIGEST_MAX_BYTES:
                entry["sha256"] = sha256_file(p)
            manifest["side"][os.path.basename(p)] = entry
    return manifest


def write_manifest_file(path: str, manifest: dict) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)
    return path


def load_manifest(ckpt_dir: str, step: int) -> Optional[dict]:
    try:
        with open(manifest_path(ckpt_dir, step)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        print(f"[checkpoint] unreadable manifest for step {step}: {e}")
        return None


def verify_step_dir(ckpt_dir: str, step: int, step_dir: Optional[str]
                    ) -> Tuple[bool, str, list]:
    """``(ok, why, side_warnings)``: digest-check one step's files against
    its manifest. No manifest = unattested (the save never committed).
    Side-file mismatches come back as warnings, not failures — meta/replay
    are atomically replaced and may legitimately postdate the step by one
    crashed save. Side files are searched in ``ckpt_dir`` and its parent
    (trainer_meta lives beside the checkpoints, best_eval above them)."""
    m = load_manifest(ckpt_dir, step)
    if m is None:
        return False, "no manifest (save did not commit)", []
    if step_dir is None:
        return False, "manifest exists but step directory is gone", []
    for rel, want in m.get("files", {}).items():
        p = os.path.join(step_dir, rel)
        if not os.path.exists(p):
            return False, f"missing file {rel}", []
        if os.path.getsize(p) != want["size"]:
            return (
                False,
                f"{rel}: size {os.path.getsize(p)} != {want['size']} "
                "(truncated?)",
                [],
            )
        if sha256_file(p) != want["sha256"]:
            return False, f"{rel}: content digest mismatch", []
    warnings = []
    parent = os.path.dirname(os.path.abspath(ckpt_dir))
    for base, want in m.get("side", {}).items():
        for cand in (os.path.join(ckpt_dir, base), os.path.join(parent, base)):
            if os.path.exists(cand):
                if os.path.getsize(cand) != want["size"] or (
                    "sha256" in want and sha256_file(cand) != want["sha256"]
                ):
                    warnings.append(
                        f"{base} differs from the step-{step} manifest "
                        "(a newer save's side file; proceeding with the "
                        "current one)"
                    )
                break
        else:
            warnings.append(f"side file {base} is missing")
    return True, "ok", warnings


def default_step_dir(ckpt_dir: str, step: int) -> Optional[str]:
    """The step directory ``<ckpt_dir>/<step>``, or None when it is gone
    (the only layout :class:`~d4pg_tpu_torch.runtime.checkpoint.CheckpointManager`
    writes)."""
    d = os.path.join(ckpt_dir, str(step))
    return d if os.path.isdir(d) else None


def intact_steps(ckpt_dir: str) -> List[int]:
    """Manifest-attested steps whose digests verify, ascending. The
    JAX-free view of what ``restore_verified`` would trust."""
    good = []
    for step in manifest_steps(ckpt_dir):
        ok, _why, _warn = verify_step_dir(
            ckpt_dir, step, default_step_dir(ckpt_dir, step)
        )
        if ok:
            good.append(step)
    return good


def fork_checkpoint(src_ckpt_dir: str, dst_ckpt_dir: str, *, depth: int = 2
                    ) -> List[int]:
    """Clone the newest ``depth`` *manifest-verified* steps (files +
    manifests + the side files the newest manifest names) from one run's
    ``checkpoints/`` dir into a fresh one — the checkpoint FORK (a
    league controller clones a variant this way). Verify-before-copy: a
    torn source step is skipped exactly as restore would skip it; copying
    more than one intact step gives the clone the same fallback depth its
    parent had (when the newest fork is torn, the clone's
    verify-on-restore falls back, never trains on torn state).

    Returns the copied steps (ascending); [] when the source has no
    intact step (or a live source's checkpoint GC kept racing the copy)
    — the caller decides whether a from-scratch clone is acceptable.
    Raises if ``dst_ckpt_dir`` already holds checkpoints (forks land in
    fresh run dirs only; an accidental overwrite of a live run is never
    recoverable).

    The source run is typically ALIVE while it is forked (the league
    clones its best variant without stopping it), so checkpoint garbage
    collection (``max_to_keep``) can delete a just-verified step under
    the copy. That race is handled, not crashed on: a vanished source
    file aborts the attempt, the partial fork is removed whole, and the
    copy retries against a FRESH verification (bounded attempts — the
    race window is milliseconds against a seconds-scale save cadence)."""
    if intact_steps(dst_ckpt_dir) or manifest_steps(dst_ckpt_dir):
        raise FileExistsError(
            f"fork target {dst_ckpt_dir} already holds checkpoints"
        )
    for _attempt in range(3):
        good = intact_steps(src_ckpt_dir)[-max(1, depth):]
        if not good:
            return []
        try:
            _copy_fork(src_ckpt_dir, dst_ckpt_dir, good)
            return good
        except (FileNotFoundError, NotADirectoryError) as e:
            # the live source's GC won the race: clean the partial fork
            # (an unattested copy would be skipped anyway, but a clean
            # retry needs an empty target) and re-verify
            print(f"[fork] source step vanished mid-copy ({e}); "
                  "re-verifying", flush=True)
            for name in manifest_steps(dst_ckpt_dir):
                try:
                    os.remove(manifest_path(dst_ckpt_dir, name))
                except FileNotFoundError:
                    pass
            for step in good:
                d = default_step_dir(dst_ckpt_dir, step)
                if d is not None:
                    shutil.rmtree(d, ignore_errors=True)
    print("[fork] source checkpoints kept churning; cloning from scratch",
          flush=True)
    return []


def _copy_fork(src_ckpt_dir: str, dst_ckpt_dir: str, good: List[int]) -> None:
    os.makedirs(dst_ckpt_dir, exist_ok=True)
    for step in good:
        src_step = default_step_dir(src_ckpt_dir, step)
        if src_step is None:
            raise FileNotFoundError(f"step {step} directory is gone")
        dst_step = os.path.join(dst_ckpt_dir, os.path.basename(src_step))
        # copy bytes first, commit record (manifest) LAST — the fork
        # itself honors the write-ordering discipline, so a crash
        # mid-fork leaves an unattested copy the clone's restore skips
        shutil.copytree(src_step, dst_step)
    newest = good[-1]
    m = load_manifest(src_ckpt_dir, newest)
    src_parent = os.path.dirname(os.path.abspath(src_ckpt_dir))
    dst_parent = os.path.dirname(os.path.abspath(dst_ckpt_dir))
    for base in (m or {}).get("side", {}):
        for src_base, dst_base in (
            (src_ckpt_dir, dst_ckpt_dir), (src_parent, dst_parent),
        ):
            cand = os.path.join(src_base, base)
            if os.path.exists(cand):
                shutil.copy2(cand, os.path.join(dst_base, base))
                break
    for step in good:
        shutil.copy2(
            manifest_path(src_ckpt_dir, step), manifest_path(dst_ckpt_dir, step)
        )
