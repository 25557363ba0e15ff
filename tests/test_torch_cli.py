"""The port's CLI and configuration against the JAX package's, on the CPU.

- every field of the port's ``TrainConfig``, ``D4PGConfig`` and
  ``DistConfig`` exists in the JAX dataclass with the same default, bar
  the port-only exceptions named in :data:`PORT_DEFAULTS`;
- every option string of ``train.build_parser()`` is accepted by the
  port's parser or refused by name (``NotImplementedError`` through
  ``refuse_unported``);
- the checkpoint and ``--resume`` pair of the CLI on the device
  placement, whose ``metrics.jsonl`` passes the repo's schema check.
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
