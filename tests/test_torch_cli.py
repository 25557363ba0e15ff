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
- data parallelism's flags (``--dp``, ``--dp-hogwild``, ``--tp``,
  ``--distributed``, ``--coordinator``, ``--num-processes``,
  ``--process-id``) parse as the JAX CLI parses them; ``--tp 2 --dp 2``
  on the device placement and the on-device loop under ``--dp`` with an
  indivisible env count are refused in the JAX package's words;
- ``--critic-head``, ``--num-mixtures``, ``--her`` and ``--her-k`` map into
  the config as the JAX CLI maps them, and so do the host actor pool's and
  obs-norm's eight flags (``--obs-norm``, ``--async-collect``,
  ``--publish-interval``, ``--concurrent-eval`` / ``--no-concurrent-eval``,
  ``--pool-start-method``, ``--pool-step-timeout``, ``--actor-device``);
- gymnasium and ``dmc:`` ids train through the CLI on one env and on the
  pool, sync and ``--async-collect``;
- ``--export-bundle`` of an ``--obs-norm`` run writes the statistics of
  ``best_obs_norm.json`` and the env's action box, which the JAX
  ``load_bundle`` reads and normalizes with identically.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
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
    for opt in ("--checkpoint-interval", "--resume", "--snapshot-replay", "--max-rss-gb",
                "--export-bundle"):
        assert opt in ours
    with pytest.raises(NotImplementedError, match="B3"):
        refuse_unported(["--device-tree-backend=pallas"])
    # the host actor pool's and obs-norm's flags (A5 (d), A10 (d)) parse,
    # data parallelism's (A7 (a)) and the collection fleet's (A11 (e2))
    for opt in HOST_POOL_FLAGS + DP_FLAGS + FLEET_FLAGS:
        assert opt in ours and opt not in UNPORTED_FLAGS, opt
    # league training's stay refused, naming its item
    for opt in ("--variant-id", "--league-generation"):
        assert opt not in ours
        with pytest.raises(NotImplementedError, match=r"A11 \(e5\)"):
            refuse_unported([opt, "1"])


FLEET_FLAGS = ("--fleet-listen", "--fleet-host", "--fleet-bundle", "--fleet-publish-interval",
               "--fleet-max-gen-lag", "--fleet-wire-dtype")


DP_FLAGS = ("--dp", "--dp-hogwild", "--tp", "--distributed", "--coordinator",
            "--num-processes", "--process-id")


def test_data_parallel_flags_map_as_the_reference_maps_them(tmp_path):
    from d4pg_tpu_torch.train import config_from_args, main

    argv = ["--dp", "4", "--dp-hogwild", "--steps-per-dispatch", "8", "--tp", "1",
            "--coordinator", "127.0.0.1:29500", "--num-processes", "2", "--process-id", "1"]
    ours, ref = build_parser().parse_args(argv), jtrain.build_parser().parse_args(argv)
    for f in ("dp", "dp_hogwild", "tp", "coordinator", "num_processes", "process_id",
              "distributed"):
        assert getattr(ours, f) == getattr(ref, f), f
    cfg, jcfg = config_from_args(ours), jtrain.config_from_args(ref)
    for f in ("dp", "dp_hogwild", "tp"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    plain = build_parser().parse_args([])
    assert (plain.dp, plain.tp, plain.num_processes, plain.process_id) == (None, 1, None, None)
    with pytest.raises(ValueError, match="sharded_megastep_dp_only"):
        main(["--device", "cpu", "--tp", "2", "--dp", "2", "--replay-placement", "device",
              "--p-replay", "--log-dir", str(tmp_path / "tp")])
    with pytest.raises(ValueError, match=r"num_envs \(3\) must be divisible by mesh axis"):
        main(["--device", "cpu", "--on-device", "--dp", "2", "--num-envs", "3",
              "--log-dir", str(tmp_path / "od")])
    with pytest.raises(ValueError, match="needs a coordinator"):
        main(["--device", "cpu", "--num-processes", "2", "--process-id", "0",
              "--log-dir", str(tmp_path / "np")])


HOST_POOL_FLAGS = ("--obs-norm", "--async-collect", "--publish-interval", "--concurrent-eval",
                   "--no-concurrent-eval", "--pool-start-method", "--pool-step-timeout",
                   "--actor-device")


def test_host_pool_flags_map_as_the_reference_maps_them():
    from d4pg_tpu_torch.train import config_from_args

    argv = ["--env", "Pendulum-v1", "--num-envs", "4", "--obs-norm", "--async-collect",
            "--publish-interval", "7", "--no-concurrent-eval", "--pool-start-method", "fork",
            "--pool-step-timeout", "12.5", "--actor-device", "cpu"]
    ours = config_from_args(build_parser().parse_args(argv))
    ref = jtrain.config_from_args(jtrain.build_parser().parse_args(argv))
    for f in ("env", "num_envs", "obs_norm", "async_collect", "publish_interval",
              "concurrent_eval", "pool_start_method", "pool_step_timeout_s", "actor_device",
              "pool_max_worker_failures"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert (ours.obs_norm, ours.publish_interval, ours.pool_step_timeout_s) == (True, 7, 12.5)
    plain, jplain = (config_from_args(build_parser().parse_args([])),
                     jtrain.config_from_args(jtrain.build_parser().parse_args([])))
    for f in ("obs_norm", "async_collect", "publish_interval", "concurrent_eval",
              "pool_start_method", "pool_step_timeout_s", "actor_device"):
        assert getattr(plain, f) == getattr(jplain, f), f


@pytest.mark.parametrize(
    "env,flags",
    [("Pendulum-v1", ["--num-envs", "1"]),
     ("Pendulum-v1", ["--num-envs", "2", "--async-collect", "--obs-norm"]),
     ("HalfCheetah-v4", ["--num-envs", "2"]),
     ("Humanoid-v4", ["--num-envs", "1", "--async-collect"]),
     ("dmc:cartpole:swingup", ["--num-envs", "2", "--async-collect", "--no-concurrent-eval"]),
     ("dmc:cartpole:swingup", ["--num-envs", "1", "--obs-norm"])],
    ids=["pendulum_1", "pendulum_2_async_obs_norm", "halfcheetah_2", "humanoid_1_async",
         "dmc_2_async", "dmc_1_obs_norm"],
)
def test_host_envs_train_through_the_cli(env, flags, tmp_path):
    from d4pg_tpu_torch.train import main

    out = main(["--device", "cpu", "--env", env, *flags, "--pool-start-method", "fork",
                "--hidden-sizes", "8", "--bsize", "8", "--warmup", "40", "--rmsize", "1024",
                "--total-steps", "6", "--eval-interval", "3", "--eval-episodes", "2",
                "--max-steps", "20", "--log-dir", str(tmp_path)])
    assert all(np.isfinite(v) for v in out.values()) and out["env_steps"] >= 40
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [3, 6]
    assert check_metrics_jsonl(str(tmp_path / "metrics.jsonl")) == []


def test_export_bundle_of_an_obs_norm_run_reads_and_normalizes_as_the_jax_bundle(tmp_path):
    from d4pg_tpu.ops.obs_norm import RunningObsNorm as JRunningObsNorm
    from d4pg_tpu.serve.bundle import load_bundle
    from d4pg_tpu_torch.ops.obs_norm import RunningObsNorm
    from d4pg_tpu_torch.train import main

    argv = ["--env", "Pendulum-v1", "--obs-norm", "--hidden-sizes", "8",
            "--log-dir", str(tmp_path / "run")]
    main(["--device", "cpu", *argv, "--num-envs", "2", "--pool-start-method", "fork",
          "--bsize", "8", "--warmup", "40", "--rmsize", "1024", "--total-steps", "4",
          "--eval-interval", "4", "--eval-episodes", "1", "--max-steps", "20"])
    main([*argv, "--export-bundle", str(tmp_path / "bundle")])
    b = load_bundle(str(tmp_path / "bundle"))
    with open(tmp_path / "run" / "checkpoints" / "best_obs_norm.json") as f:
        best = json.load(f)
    assert b.obs_norm == best and best["count"] > 0
    np.testing.assert_array_equal(b.action_low, [-2.0]) and np.testing.assert_array_equal(
        b.action_high, [2.0])
    ref, ours = JRunningObsNorm(3), RunningObsNorm(3)
    ref.load_state_dict(b.obs_norm)
    ours.load_state_dict(best)
    x = np.random.default_rng(0).normal(size=(32, 3)).astype(np.float32) * 3
    np.testing.assert_array_equal(ref.normalize(x), ours.normalize(x))
    assert b.config.obs_dim == 3 and b.config.action_dim == 1


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
