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
        "import d4pg_tpu_torch.chaos, d4pg_tpu_torch.netio.attack\n"
        "import d4pg_tpu_torch.analysis.transfer, d4pg_tpu_torch.analysis.flowledger\n"
        "import d4pg_tpu_torch.fleet.actor, d4pg_tpu_torch.fleet.ingest\n"
        "import d4pg_tpu_torch.replay.source\n"
        "import d4pg_tpu_torch.league, d4pg_tpu_torch.league.controller\n"
        "import d4pg_tpu_torch.league.__main__, d4pg_tpu_torch.tools.multihost_smoke\n"
        "import d4pg_tpu_torch.tools.league_stub_learner\n"
        "import d4pg_tpu_torch.analysis.recompile, d4pg_tpu_torch.utils.graphs\n"
        "import d4pg_tpu_torch.utils.backend_probe\n"
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


# The JAX modules with no file of the same path in the port, and why: the
# Pallas kernels became the CUDA modules ops/cuda_*.py (ROADMAP queue B);
# parallel/compat.py only picks where the JAX version keeps shard_map.
JAX_ONLY = {"ops/pallas_projection.py": "ops/cuda_projection.py",
            "ops/pallas_tree.py": "ops/cuda_tree.py",
            "ops/pallas_fused_step.py": "ops/cuda_fused_step.py",
            "parallel/compat.py": None}


def _modules(root):
    return {os.path.relpath(os.path.join(d, n), root) for d, _, names in os.walk(root)
            for n in names if n.endswith(".py")}


def test_every_jax_module_has_a_counterpart_in_the_port():
    """A file list of ``d4pg_tpu/`` against ``d4pg_tpu_torch/`` leaves only
    the Pallas kernels (ported as ``ops/cuda_*.py``) and ``parallel/
    compat.py``."""
    missing = _modules(os.path.join(REPO, "d4pg_tpu")) - _modules(PKG)
    assert missing == set(JAX_ONLY)
    for port in filter(None, JAX_ONLY.values()):
        assert os.path.exists(os.path.join(PKG, port)), port


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
    [("tp", 2, "A7"), ("dp_hogwild", True, "A7"), ("num_processes", 2, "A7"),
     ("process_id", 1, "A7"), ("fleet_publish_interval", 5, "A11"),
     ("league_generation", 3, "A11"), ("variant_id", 1, "A11"),
     ("dp", 2, "A7"), ("fleet_listen", 0, "A11"), ("chaos", "kill@3", "A11")],
)
def test_unported_train_options_raise_naming_the_roadmap_item(field, value, item, tmp_path):
    """A flag of the unported table raises naming its ROADMAP item before
    any run. The data-parallel flags (ported with A7 (a)-(c)) are refused
    before any run by the gap or error the JAX CLI names for the same
    request: ``--tp 2`` with ``--dp 2`` on the device placement
    (``sharded_megastep_dp_only``), ``--dp 2`` on the on-device loop over
    3 envs (the mesh's divisibility error), ``--num-processes 2`` without
    a coordinator. ``--chaos`` (ported with A11 (e1)) refuses the plan
    ``kill@3`` with the chaos parser's own ``ValueError``. The fleet's
    flags (ported with A11 (e2)) are refused by the JAX gaps of the same
    requests, before any env or learner: ``--fleet-publish-interval``
    with a ``--fleet-bundle`` and no ``--fleet-listen``
    (``fleet_bundle_requires_listen``), ``--fleet-listen`` on the
    on-device loop (``on_device_fleet``); the CLI exits with the gap's
    words. League training's flags (ported with A11 (e5)) parse into the
    config's ``variant_id`` and ``league_generation``."""
    from d4pg_tpu_torch.train import UNPORTED_FLAGS, build_parser, config_from_args, main

    flag = "--" + field.replace("_", "-")
    arg = flag if value is True else f"{flag}={value}"
    if field in LEAGUE_FIELDS:
        assert flag not in UNPORTED_FLAGS
        cfg = config_from_args(build_parser().parse_args(["--log-dir", str(tmp_path), arg]))
        assert getattr(cfg, field) == value
        return
    extra, exc, match = A7_REFUSALS.get(field, ([], NotImplementedError, item))
    if field not in A7_REFUSALS:
        assert flag in UNPORTED_FLAGS
    with pytest.raises(exc, match=match):
        main(["--device", "cpu", "--log-dir", str(tmp_path), "--hidden-sizes", "8", arg, *extra])
    assert not (tmp_path / "metrics.jsonl").exists()


LEAGUE_FIELDS = ("variant_id", "league_generation")

# the A7 flags, --chaos and the fleet flags of the case above: (further
# flags, error, its words)
A7_REFUSALS = {
    "fleet_publish_interval": (["--fleet-bundle=b"], SystemExit, "fleet_bundle_requires_listen"),
    "fleet_listen": (["--on-device"], SystemExit, "on_device_fleet"),
    "chaos": ([], ValueError, r"bad chaos entry 'kill@3': unknown site 'kill'"),
    "tp": (["--dp=2", "--replay-placement=device", "--p-replay"], ValueError,
           "sharded_megastep_dp_only"),
    "dp": (["--on-device", "--num-envs=3"], ValueError,
           r"num_envs \(3\) must be divisible by mesh axis 'dp' size 2"),
    "num_processes": (["--on-device"], ValueError, "needs a coordinator"),
    "dp_hogwild": ([], ValueError, "dp_hogwild_requires_dp"),
    "process_id": (["--coordinator=127.0.0.1:1"], ValueError, "needs --num-processes"),
}


def test_cli_refuses_unknown_flags(tmp_path):
    from d4pg_tpu_torch.train import main

    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--log-dir", str(tmp_path), "--no-such-flag"])


@pytest.mark.parametrize(
    "flag", ["--obs-norm", "--fleet-listen=0", "--chaos=host_kill@2:1", "--dp-hogwild",
             "--tp=2", "--transfer-dtype=uint8", "--dp=2"],
)
def test_cli_refuses_unported_flags(flag, tmp_path):
    """Each flag is refused on the default (flat, torch) env: the unported
    ones naming their ROADMAP item; the uint8 wire, ported with pixels
    (A10 (c)), by the JAX package's ``uint8_wire_requires_pixel`` gap, and
    ``--obs-norm``, ported for host envs (A10 (d)), by its
    ``obs_norm_flat_envs_only`` gap. The data-parallel flags (A7 (a)-(c))
    are refused by the gaps the JAX CLI names: ``--dp-hogwild`` alone by
    ``dp_hogwild_requires_dp``, ``--tp=2`` with ``--dp=2`` on the device
    placement by ``sharded_megastep_dp_only``, and ``--dp=2`` on the
    on-device loop over 3 envs by the mesh's divisibility error. ``--chaos``
    (A11 (e1)) takes ``host_kill`` with ``--num-processes 2`` since its
    relaunching supervisor came (A11 (f)): the flags parse into the config.
    ``--fleet-listen`` (A11 (e2)) on the on-device loop is refused by the
    ``on_device_fleet`` gap: the CLI exits with its words before any env
    or learner."""
    from d4pg_tpu_torch.train import build_parser, config_from_args, main

    if flag == "--chaos=host_kill@2:1":
        cfg = config_from_args(build_parser().parse_args(
            ["--log-dir", str(tmp_path), flag, "--num-processes=2"]))
        assert (cfg.chaos, cfg.num_processes) == ("host_kill@2:1", 2)
        return
    gaps = ("--transfer-dtype=uint8", "--obs-norm", "--dp-hogwild", "--tp=2", "--dp=2")
    exc = ValueError if flag in gaps else SystemExit if flag.startswith("--fleet") \
        else NotImplementedError
    extra = {"--dp=2": ["--on-device", "--num-envs=3"],
             "--tp=2": ["--dp=2", "--replay-placement=device", "--p-replay"],
             "--fleet-listen=0": ["--on-device"]}.get(flag, [])
    match = {"--fleet-listen=0": "on_device_fleet"}.get(flag)
    with pytest.raises(exc, match=match):
        main(["--device", "cpu", "--log-dir", str(tmp_path), "--hidden-sizes", "8", flag, *extra])


def test_package_docstring_names_the_device_rule():
    assert "device" in d4pg_tpu_torch.__doc__
