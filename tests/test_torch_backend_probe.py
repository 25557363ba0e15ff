"""The port's device probe (``d4pg_tpu_torch/utils/backend_probe.py``), the
counterpart of ``d4pg_tpu/utils/backend_probe.py``: a child that fails,
hangs or prints garbage gives ``(None, 0)``, the answer is memoized, and
importing the probe imports no torch."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from d4pg_tpu_torch.utils import backend_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def probe(monkeypatch):
    """The probe with its memo cleared before and after, and its child's
    program replaceable."""
    backend_probe.probe_default_backend.cache_clear()
    yield lambda code: monkeypatch.setattr(backend_probe, "PROBE", code)
    backend_probe.probe_default_backend.cache_clear()


@pytest.mark.parametrize("code", [
    "raise SystemExit(3)",                       # the child fails
    "import time; time.sleep(30)",               # the child hangs past the timeout
    "print('no card here')",                     # garbage
    "print('cuda')\nprint('many')",              # a count that is no number
    "print('none')\nprint(0)",                   # torch answers: no card
])
def test_a_failing_hanging_or_garbled_child_gives_none(probe, code, monkeypatch):
    probe(code)
    monkeypatch.setenv("GRAFT_PROBE_TIMEOUT", "2")
    assert backend_probe.probe_default_backend() == (None, 0)


def test_a_card_reported_by_the_child_is_returned_and_memoized(probe, tmp_path):
    marker = tmp_path / "calls"
    probe(f"open({str(marker)!r}, 'a').write('x')\nprint('cuda')\nprint(2)")
    assert backend_probe.probe_default_backend() == ("cuda", 2)
    assert backend_probe.probe_default_backend() == ("cuda", 2)
    assert marker.read_text() == "x"  # one child for both calls


def test_this_machine_has_no_card_to_find(probe):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert backend_probe.probe_default_backend() == (None, 0)


def test_importing_the_probe_imports_no_torch():
    code = ("import sys\nimport d4pg_tpu_torch.utils.backend_probe\n"
            "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_jax_probe_gives_the_same_failure_answer(monkeypatch):
    """Both packages' probes answer ``(None, 0)`` to a child that times out."""
    from d4pg_tpu.utils import backend_probe as jprobe

    monkeypatch.setenv("GRAFT_PROBE_TIMEOUT", "2")
    monkeypatch.setattr(subprocess, "run", _timeout)
    jprobe.probe_default_backend.cache_clear()
    backend_probe.probe_default_backend.cache_clear()
    try:
        assert jprobe.probe_default_backend() == backend_probe.probe_default_backend() == (None, 0)
    finally:
        jprobe.probe_default_backend.cache_clear()
        backend_probe.probe_default_backend.cache_clear()


def _timeout(*args, **kw):
    raise subprocess.TimeoutExpired(args[0], kw.get("timeout"))
