#!/usr/bin/env python3
"""Regenerate the spatial envs' model snapshots.

    python3 d4pg_tpu_torch/tools/extract_spatial.py [--out DIR]

Runs :func:`d4pg_tpu_torch.envs.spatial.extract_spatial_model` on the
installed gymnasium MuJoCo assets ``humanoid.xml`` and ``ant.xml`` and
writes one ``.npz`` per asset (every field of ``SpatialModel``) to ``DIR``
(default: ``d4pg_tpu_torch/envs/assets/``, where the envs load them).
Needs ``gymnasium`` and ``mujoco``; the envs themselves need neither.
Prints one line per asset: its path, nq, nv and the body, joint, actuator
and contact-sphere counts.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSETS = ("humanoid.xml", "ant.xml")


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from d4pg_tpu_torch.envs.spatial import ASSETS as OUT, extract_spatial_model, save_model
    from d4pg_tpu_torch.tools.extract_planar import gym_xml

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for asset in ASSETS:
        model = extract_spatial_model(gym_xml(asset))
        path = os.path.join(args.out, os.path.splitext(asset)[0] + ".npz")
        save_model(model, path)
        print(f"{path}: nq {model.nq}, nv {model.nv}, {len(model.parent)} bodies, "
              f"{len(model.jnt_body)} joints, {len(model.gear)} actuators, "
              f"{len(model.con_body)} contact spheres")
    return 0


if __name__ == "__main__":
    sys.exit(main())
