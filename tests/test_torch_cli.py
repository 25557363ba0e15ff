"""The port's CLI and configuration against the JAX package's, on the CPU.

- every field of the port's ``TrainConfig``, ``D4PGConfig`` and
  ``DistConfig`` exists in the JAX dataclass with the same default, bar
  the port-only exceptions named in :data:`PORT_DEFAULTS`;
- every option string of ``train.build_parser()`` is accepted by the
  port's parser or refused by name (``NotImplementedError`` through
  ``refuse_unported``);
- the checkpoint and ``--resume`` pair of the CLI on the device
  placement, whose ``metrics.jsonl`` passes the repo's schema check;
- the critic support the port's ``Trainer`` ends with equals the JAX
  trainer's ``_reconcile_config(config_from_args(argv), env)``, one-sided
  ``--v-min`` / ``--v-max`` included, for every head;
- ``--critic-head``, ``--num-mixtures``, ``--her`` and ``--her-k`` map into
  the config as the JAX CLI maps them.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

import train as jtrain
from d4pg_tpu.agent.state import D4PGConfig as JD4PGConfig
from d4pg_tpu.config import TrainConfig as JTrainConfig
from d4pg_tpu.models.critic import DistConfig as JDistConfig
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.models.critic import DistConfig
from d4pg_tpu_torch.train import UNPORTED_FLAGS, build_parser, refuse_unported
from tools.d4pglint.schema_check import check_metrics_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Port-only defaults: the port names its projection ladder in its own words
# ("fused" = the reference's "pallas_fused", "projection" = "pallas"; the
# reference's default "xla" rung has no port). A nested config holding such
# a field differs only through it.
PORT_DEFAULTS = {("D4PGConfig", "projection_backend"): ("fused", "xla")}


@pytest.mark.parametrize(
    "ours,ref", [(TrainConfig, JTrainConfig), (D4PGConfig, JD4PGConfig), (DistConfig, JDistConfig)],
    ids=["TrainConfig", "D4PGConfig", "DistConfig"],
)
def test_config_fields_and_defaults_match_the_reference(ours, ref):
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    mine, theirs = ours(), ref()
    for f in dataclasses.fields(ours):
        assert f.name in ref_fields, f"{ours.__name__}.{f.name} is not a field of the reference"
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            continue  # held field by field by its own case
        exception = PORT_DEFAULTS.get((ours.__name__, f.name))
        if exception is not None:
            assert (a, b) == exception, (f.name, a, b)
        else:
            assert a == b, (f"{ours.__name__}.{f.name}", a, b)


def test_every_reference_flag_is_accepted_or_refused_by_name():
    ours = {o for a in build_parser()._actions for o in a.option_strings}
    ref = [o for a in jtrain.build_parser()._actions for o in a.option_strings]
    assert len(ref) > 80
    for opt in ref:
        if opt in ours:
            assert opt not in UNPORTED_FLAGS, opt
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP A"):
            refuse_unported([opt])
    for opt in ("--checkpoint-interval", "--resume", "--snapshot-replay", "--max-rss-gb"):
        assert opt in ours
    with pytest.raises(NotImplementedError, match="B3"):
        refuse_unported(["--device-tree-backend=pallas"])


def _run(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", "d4pg_tpu_torch.train", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_checkpoint_then_resume_on_the_device_placement(tmp_path):
    args = ["--device", "cpu", "--replay-placement", "device", "--p-replay",
            "--steps-per-dispatch", "4", "--fused-descent", "--hidden-sizes", "16,16",
            "--num-envs", "2", "--bsize", "8", "--warmup", "64", "--rmsize", "4096",
            "--total-steps", "16", "--eval-interval", "8", "--eval-episodes", "1",
            "--checkpoint-interval", "8", "--snapshot-replay", "--log-dir", str(tmp_path)]
    first = _run(args)
    assert first.returncode == 0, first.stdout[-2000:] + first.stderr[-2000:]
    second = _run(args + ["--resume"])
    assert second.returncode == 0, second.stdout[-2000:] + second.stderr[-2000:]
    assert "[checkpoint] resumed from step 16" in second.stdout
    assert "restored device-PER priorities" in second.stdout
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [8, 16, 24, 32]
    # the resumed leg's rows: its save at 24 is counted, the one at 32
    # follows the row
    assert rows[-1]["stage_checkpoint_save_calls"] == 1.0
    assert rows[-1]["stage_checkpoint_restore_calls"] == 1.0
    assert check_metrics_jsonl(str(tmp_path / "metrics.jsonl")) == []
    ck = tmp_path / "checkpoints"
    assert sorted(os.listdir(ck)) == sorted(
        ["16", "24", "32", "manifest_16.json", "manifest_24.json", "manifest_32.json",
         "trainer_meta.json", "replay.npz", "device_per.npz", "best_actor.npz"])


SUPPORT_ARGV = {
    "halfcheetah_vmin": ["--env", "halfcheetah", "--v-min", "-100"],
    "pendulum_vmax": ["--env", "pendulum", "--v-max", "10"],
    "pendulum_defaults_explicit": ["--env", "pendulum", "--v-min", "-10", "--v-max", "10"],
    "pendulum_mog": ["--env", "pendulum", "--critic-head", "mixture_gaussian"],
    "pointmass_scalar_vmin": ["--env", "pointmass_goal", "--critic-head", "scalar",
                              "--v-min", "-20"],
}


def _port_trainer(cfg, tmp_path):
    from d4pg_tpu_torch.runtime.trainer import Trainer

    t = Trainer(cfg, device="cpu")
    t.close()
    return t


def _jax_support(jcfg, port_cfg):
    """The JAX trainer's support: ``_reconcile_config`` on an env stub with
    the preset's dims (the support rule reads the preset, not the env)."""
    import types

    from d4pg_tpu.runtime.trainer import _reconcile_config

    a = port_cfg.agent
    env = types.SimpleNamespace(observation_dim=a.obs_dim, action_dim=a.action_dim,
                                max_episode_steps=port_cfg.max_episode_steps)
    d = _reconcile_config(jcfg, env).agent.dist
    return d.kind, d.v_min, d.v_max, d.num_mixtures


@pytest.mark.parametrize("case", list(SUPPORT_ARGV) + ["mog_from_code"])
def test_resolved_support_matches_the_jax_trainer(case, tmp_path):
    from d4pg_tpu_torch.train import config_from_args

    small = ["--hidden-sizes", "8", "--rmsize", "256", "--num-envs", "2",
             "--log-dir", str(tmp_path)]
    if case == "mog_from_code":
        jcfg = JTrainConfig(env="pendulum", agent=JD4PGConfig(dist=JDistConfig(
            kind="mixture_gaussian")))
        cfg = TrainConfig(env="pendulum", replay_capacity=256, num_envs=2, log_dir=str(tmp_path),
                          agent=D4PGConfig(hidden_sizes=(8,),
                                           dist=DistConfig(kind="mixture_gaussian")))
    else:
        argv = SUPPORT_ARGV[case]
        jcfg = jtrain.config_from_args(jtrain.build_parser().parse_args(argv))
        cfg = config_from_args(build_parser().parse_args(argv + small))
    t = _port_trainer(cfg, tmp_path)
    d = t.config.agent.dist
    assert (d.kind, d.v_min, d.v_max, d.num_mixtures) == _jax_support(jcfg, t.config), case
    if case == "mog_from_code":  # the MoG head keeps the DistConfig defaults
        assert (d.v_min, d.v_max) == (-10.0, 10.0)


def test_head_and_her_flags_map_as_the_reference_maps_them():
    from d4pg_tpu_torch.train import config_from_args

    argv = ["--env", "pointmass_goal", "--critic-head", "mixture_gaussian", "--num-mixtures",
            "7", "--her", "--her-k", "6", "--n-step", "1"]
    ours = config_from_args(build_parser().parse_args(argv))
    ref = jtrain.config_from_args(jtrain.build_parser().parse_args(argv))
    assert (ours.her, ours.her_k) == (ref.her, ref.her_k) == (True, 6)
    for f in ("kind", "num_mixtures", "num_atoms", "quadrature_points", "v_min", "v_max"):
        assert getattr(ours.agent.dist, f) == getattr(ref.agent.dist, f), f
    assert ours.log_dir == "runs/torch_pointmass_goal_PER_HER_n1_16env"
    assert ref.log_dir == "runs/pointmass_goal_PER_HER_n1_16env"
    for flag in ("--critic-head", "--num-mixtures", "--her", "--her-k"):
        assert flag not in UNPORTED_FLAGS
    plain = config_from_args(build_parser().parse_args([]))
    assert (plain.her, plain.her_k, plain.agent.dist.kind) == (False, 4, "categorical")
