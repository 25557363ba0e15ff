"""The port's package seam: it imports no JAX and nothing of ``d4pg_tpu``,
and its entry points run on the CUDA card unless the caller asks for the
CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import d4pg_tpu_torch
from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.config import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "d4pg_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "d4pg_tpu"}


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "import d4pg_tpu_torch, d4pg_tpu_torch.train, d4pg_tpu_torch.runtime.trainer\n"
        "import d4pg_tpu_torch.runtime.on_device, d4pg_tpu_torch.envs.planar\n"
        "import d4pg_tpu_torch.envs.locomotion, d4pg_tpu_torch.envs.pointmass_goal\n"
        "import d4pg_tpu_torch.tools.extract_planar\n"
        "import d4pg_tpu_torch.serve.server, d4pg_tpu_torch.serve.client\n"
        "import d4pg_tpu_torch.serve.__main__, d4pg_tpu_torch.netio\n"
        "import d4pg_tpu_torch.utils.retry\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_no_source_file_imports_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 20
    bad = [(f, m) for f in files for m in _imports(f) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_resolve_device_raises_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    for asked in (None, "cuda", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(asked)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_resolve_device_pins_float32_matmuls(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device(None) == torch.device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from d4pg_tpu_torch.agent import D4PGConfig, create_train_state
    from d4pg_tpu_torch.runtime.trainer import Trainer
    from d4pg_tpu_torch.train import main

    _no_card(monkeypatch)
    with pytest.raises(RuntimeError):
        create_train_state(D4PGConfig(hidden_sizes=(8,)))
    with pytest.raises(RuntimeError):
        Trainer(TrainConfig(log_dir=str(tmp_path)))
    with pytest.raises(RuntimeError):
        main(["--log-dir", str(tmp_path), "--hidden-sizes", "8"])
    assert not (tmp_path / "metrics.jsonl").exists()


def test_envs_and_the_on_device_loop_import_no_mujoco_or_gymnasium():
    """The planar envs load the committed snapshot: a run needs neither
    package (only tools/extract_planar.py does, inside its function)."""
    code = (
        "import sys, torch\n"
        "from d4pg_tpu_torch.envs import make_env\n"
        "import d4pg_tpu_torch.runtime.on_device, d4pg_tpu_torch.tools.extract_planar\n"
        "env = make_env('halfcheetah')\n"
        "state, obs = env.reset(2, torch.Generator().manual_seed(0))\n"
        "env.step(state, torch.zeros(2, 6))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('mujoco', 'gymnasium'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_on_device_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from d4pg_tpu_torch.runtime.on_device import OnDeviceRun, run_on_device
    from d4pg_tpu_torch.train import main

    _no_card(monkeypatch)
    cfg = TrainConfig(env="halfcheetah", log_dir=str(tmp_path))
    for entry in (OnDeviceRun, run_on_device):
        with pytest.raises(RuntimeError, match="--device cpu"):
            entry(cfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--on-device", "--env", "halfcheetah", "--hidden-sizes", "16,16", "--num-envs", "2",
              "--bsize", "16", "--warmup", "64", "--rmsize", "4096", "--total-steps", "128",
              "--eval-interval", "64", "--eval-episodes", "1", "--max-steps", "50",
              "--log-dir", str(tmp_path)])
    assert not (tmp_path / "metrics.jsonl").exists()


@pytest.mark.parametrize(
    "field,value,item",
    [("tp", 2, "A7"), ("obs_norm", True, "A10"), ("async_collect", True, "A5"),
     ("publish_interval", 5, "A5"), ("pool_start_method", "fork", "A5"),
     ("league_generation", 3, "A11"), ("variant_id", 1, "A11"),
     ("dp", 2, "A7"), ("fleet_listen", 0, "A11"), ("chaos", "kill@3", "A11")],
)
def test_unported_train_options_raise_naming_the_roadmap_item(field, value, item, tmp_path):
    """A flag of the unported table raises naming its ROADMAP item before
    any run."""
    from d4pg_tpu_torch.train import UNPORTED_FLAGS, main

    flag = "--" + field.replace("_", "-")
    assert flag in UNPORTED_FLAGS
    arg = flag if value is True else f"{flag}={value}"
    with pytest.raises(NotImplementedError, match=item):
        main(["--device", "cpu", "--log-dir", str(tmp_path), "--hidden-sizes", "8", arg])
    assert not (tmp_path / "metrics.jsonl").exists()


def test_cli_refuses_unknown_flags(tmp_path):
    from d4pg_tpu_torch.train import main

    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--log-dir", str(tmp_path), "--no-such-flag"])


@pytest.mark.parametrize(
    "flag", ["--obs-norm", "--concurrent-eval", "--chaos=kill@3", "--dp-hogwild",
             "--actor-device=cpu", "--transfer-dtype=uint8", "--dp=2"],
)
def test_cli_refuses_unported_flags(flag, tmp_path):
    """Each flag is refused on the default (flat) env: the unported ones
    naming their ROADMAP item; the uint8 wire, ported with pixels (A10
    (c)), by the JAX package's ``uint8_wire_requires_pixel`` gap."""
    from d4pg_tpu_torch.train import main

    exc = ValueError if flag == "--transfer-dtype=uint8" else NotImplementedError
    with pytest.raises(exc):
        main(["--device", "cpu", "--log-dir", str(tmp_path), "--hidden-sizes", "8", flag])


def test_package_docstring_names_the_device_rule():
    assert "device" in d4pg_tpu_torch.__doc__
