#!/usr/bin/env python3
"""Regenerate the planar envs' model snapshots.

    python3 d4pg_tpu_torch/tools/extract_planar.py [--out DIR]

Runs :func:`d4pg_tpu_torch.envs.planar.extract_planar_model` on the
installed gymnasium MuJoCo assets ``half_cheetah.xml``, ``hopper.xml`` and
``walker2d.xml`` and writes one ``.npz`` per asset (every field of
``PlanarModel``) to ``DIR`` (default: ``d4pg_tpu_torch/envs/assets/``,
where the envs load them). Needs ``gymnasium`` and ``mujoco``; the envs
themselves need neither. Prints one line per asset: its path and the
body, joint, actuator and contact-sphere counts.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSETS = ("half_cheetah.xml", "hopper.xml", "walker2d.xml")


def gym_xml(asset: str) -> str:
    """Path of ``asset`` in the installed gymnasium's MuJoCo assets."""
    import gymnasium.envs.mujoco as gm

    return os.path.join(os.path.dirname(gm.__file__), "assets", asset)


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from d4pg_tpu_torch.envs.planar import ASSETS as OUT, extract_planar_model, save_model

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for asset in ASSETS:
        model = extract_planar_model(gym_xml(asset))
        path = os.path.join(args.out, os.path.splitext(asset)[0] + ".npz")
        save_model(model, path)
        print(f"{path}: {len(model.parent)} bodies, {len(model.jnt_body)} joints, "
              f"{len(model.gear)} actuators, {len(model.con_body)} contact spheres")
    return 0


if __name__ == "__main__":
    sys.exit(main())
