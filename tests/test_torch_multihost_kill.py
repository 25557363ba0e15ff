"""Recovery from ``host_kill`` across processes (``d4pg_tpu_torch/tools/
multihost_smoke.py``), on the CPU at a narrow width, against the JAX
package's supervisor script and against one process.

The two legs of ``scripts/multihost_smoke.sh`` run through the port's
harness: two CLI processes (``--dp 2 --num-processes 2``, one lane each,
over gloo) on the device placement with the replay snapshot; process 1
SIGKILLed at its 4th dispatch (K = 4) after the checkpoint at step 8 and
before the one at 16; the survivor reaped by SIGKILL; both relaunched
with ``--resume`` for 8 more grad steps. The resumed two-process run is
then held ``torch.equal`` to ONE process with two lanes resumed from a
copy of the same checkpoint for the same 8 grad steps: every tensor of
the final ``state.pt`` (params, targets, both Adam moment sets) and the
final replay snapshot and device-PER sidecar. Neither resumed leg
collects (its 2 dispatches' budget of 8 env steps stays below one
segment of 2 envs x 32 steps), so both train on the dealt restored rows,
drawn by the same ``(seed, lane)`` generators. The processes run with
one CPU thread each (CPU GEMM bits depend on the thread split).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from d4pg_tpu_torch.tools import multihost_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, INTERVAL, KILL_AT = 4, 8, 4
LEG1_STEPS, LEG2_STEPS = 32, 8
NARROW = ["--hidden-sizes", "16,16", "--num-envs", "2", "--bsize", "8", "--warmup", "64",
          "--rmsize", "4096", "--eval-interval", "100000", "--eval-episodes", "1"]
TIMEOUT_S = 240.0


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _state(run, step):
    return dict(_flat(torch.load(os.path.join(run, "checkpoints", str(step), "state.pt"),
                                 map_location="cpu", weights_only=True)))


@pytest.mark.parametrize(
    "kill_at,k,interval,expect",
    [(4, 4, 8, 8), (18, 1, 12, 12), (4, 8, 16, 16), (6, 4, 8, 16), (5, 4, 8, None),
     (3, 4, 8, None), (2, 8, 16, None), (4, 4, 16, None)],
)
def test_committed_step_lands_the_kill_strictly_between_two_saves(kill_at, k, interval, expect):
    """The JAX script's choice (c = 12, N = 18 at K = 1) and the port's
    (c = 8 at K = 4, c = 16 at K = 8) pass; a kill in the dispatch right
    after a save (whose manifest process 0 may still be writing) or before
    any save is refused."""
    if expect is None:
        with pytest.raises(ValueError, match="must follow a save"):
            multihost_smoke.committed_step(kill_at, k, interval)
    else:
        assert multihost_smoke.committed_step(kill_at, k, interval) == expect


def test_host_kill_relaunch_resumes_both_ranks_equal_to_one_process(tmp_path):
    run = str(tmp_path / "run")
    os.makedirs(run)
    kw = dict(device="cpu", k=K, interval=INTERVAL, extra=NARROW, env=_env(),
              timeout_s=TIMEOUT_S)
    leg1 = multihost_smoke.kill_leg(run, kill_at=KILL_AT, total=LEG1_STEPS, **kw)
    c = leg1["committed_step"]
    assert c == 8 and leg1["manifest_steps"] == [8]
    assert leg1["victim_rc"] == -9 and leg1["survivor_rc"] is not None
    assert "at grad step 12" in leg1["kill_line"]
    assert not any(x.isdigit() and int(x) > c for x in os.listdir(os.path.join(run, "checkpoints")))
    one = str(tmp_path / "one")
    shutil.copytree(os.path.join(run, "checkpoints"), os.path.join(one, "checkpoints"))

    leg2 = multihost_smoke.relaunch_leg(run, c, total=LEG2_STEPS, **kw)
    assert leg2["rcs"] == [0, 0] and leg2["resumed_from"] == c
    # each process dealt itself its lanes' rows of the 128 saved ones
    assert [r["replay_rows_restored"] for r in leg2["ranks"]] == [64, 64]
    assert np.isfinite(leg2["model_metrics"]["critic_loss"])
    # the kernels' plain versions on the CPU count no launch
    assert all(set(r["launches"].values()) == {0} for r in leg2["ranks"])
    assert multihost_smoke.spawnlib.reap_orphans() == []
    assert multihost_smoke._leftovers(run) == []

    argv = [sys.executable, "-m", "d4pg_tpu_torch.train", "--device", "cpu",
            "--replay-placement", "device", "--p-replay", "--steps-per-dispatch", str(K),
            "--dp", "2", "--checkpoint-interval", str(INTERVAL), "--snapshot-replay",
            "--total-steps", str(LEG2_STEPS), "--resume", "--log-dir", one, *NARROW]
    out = subprocess.run(argv, cwd=REPO, env=_env(), capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert f"resumed from step {c}" in out.stdout
    assert "restored replay snapshot: 128 transitions" in out.stdout
    assert "restored device-PER priorities" in out.stdout
    end = c + LEG2_STEPS
    ranks, lanes = _state(run, end), _state(one, end)
    assert ranks.keys() == lanes.keys() and len(ranks) > 10
    for key in ranks:
        a, b = ranks[key], lanes[key]
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), key
        else:
            assert a == b, key
    for name in ("replay.npz", "device_per.npz"):
        with np.load(os.path.join(run, "checkpoints", name)) as x, \
                np.load(os.path.join(one, "checkpoints", name)) as y:
            assert sorted(x.files) == sorted(y.files)
            for f in x.files:
                np.testing.assert_array_equal(x[f], y[f], err_msg=f"{name}:{f}")
    one_done = multihost_smoke.parse_done(out.stdout.splitlines())
    for key in ("critic_loss", "actor_loss", "priority_mean", "q_mean", "eval_return_mean"):
        assert one_done[key] == leg2["model_metrics"][key], key


@pytest.mark.parametrize(
    "argv,device,extra,fails",
    [(["--dir", "d"], "cuda", [], False),
     (["--dir", "d", "--device", "cpu", "--", "--hidden-sizes", "16,16"], "cpu",
      ["--hidden-sizes", "16,16"], False),
     (["--dir", "d", "--device", "cpu"], "cpu", [], True)],
)
def test_main_runs_both_legs_at_the_defaults_with_the_device_and_train_flags(
        monkeypatch, capsys, argv, device, extra, fails):
    """The command line sets only the run dir, the device and the train
    flags after ``--``; every leg knob stays at :func:`run`'s defaults. A
    failed check prints ``ok: false`` and exits 1."""
    seen = {}

    def fake_run(run_dir, **kw):
        seen.update(run_dir=run_dir, **kw)
        if fails:
            raise multihost_smoke.SupervisorError("leg 2: exit codes [0, 1]")
        return {"leg1": {}, "leg2": {}, "orphans_swept": []}

    monkeypatch.setattr(multihost_smoke, "run", fake_run)
    assert multihost_smoke.main(argv) == (1 if fails else 0)
    assert seen == {"run_dir": "d", "device": device, "extra": extra}
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] is not fails
    if fails:
        assert out["error"] == "leg 2: exit codes [0, 1]"
