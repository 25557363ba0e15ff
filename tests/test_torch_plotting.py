"""The port's offline plotting (``d4pg_tpu_torch/utils/plotting.py``) held
against the JAX package's (``d4pg_tpu/utils/plotting.py``): the same
smoothing bits, the same columns from the same ``metrics.jsonl``, and a
PNG written from a run the port's own logger wrote."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from d4pg_tpu.utils import plotting as jplot
from d4pg_tpu_torch.utils import plotting as plot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n,window", [(1, 5), (7, 1), (500, 20), (4096, 3)])
def test_ewma_equals_the_jax_ewma(n, window):
    x = np.random.default_rng(n + window).normal(size=n) * 100.0
    ours, ref = plot.ewma(x, window), jplot.ewma(x, window)
    assert ours.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("bad", [np.zeros((3, 3)), "window0"])
def test_ewma_refuses_what_the_jax_ewma_refuses(bad):
    data, window = (bad, 5) if isinstance(bad, np.ndarray) else (np.zeros(4), 0)
    with pytest.raises(ValueError) as ours:
        plot.ewma(data, window)
    with pytest.raises(ValueError) as ref:
        jplot.ewma(data, window)
    assert str(ours.value) == str(ref.value)
    assert plot.ewma(np.array([]), 5).size == 0


def _write_run(d, seed: int) -> str:
    """A run dir with train rows every step and sparser eval rows, from a
    seed, as the port's MetricsLogger writes them."""
    from d4pg_tpu_torch.runtime.metrics import MetricsLogger

    rng = np.random.default_rng(seed)
    logger = MetricsLogger(str(d))
    for i in range(12):
        logger.log(i * 50, {"critic_loss": float(rng.random()), "q_mean": float(rng.normal())})
        if i % 3 == 0:
            logger.log(i * 50, {"eval_return_mean": float(rng.normal() * 100.0)})
    logger.close()
    return str(d)


def test_load_run_equals_the_jax_load_run(tmp_path):
    d = _write_run(tmp_path / "run", 3)
    ours, ref = plot.load_run(d), jplot.load_run(d)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    assert plot.available_metrics(ours) == jplot.available_metrics(ref) == [
        "critic_loss", "eval_return_mean", "q_mean"]
    np.testing.assert_array_equal(ours["eval_return_mean/step"], [0, 150, 300, 450])


@pytest.mark.parametrize("x", ["step", "t"])
def test_compare_runs_writes_a_png(tmp_path, x, capsys):
    runs = [_write_run(tmp_path / f"r{i}", i) for i in range(2)]
    out = str(tmp_path / f"cmp_{x}.png")
    fig = plot.compare_runs(runs + [str(tmp_path / "missing")], metric="eval_return_mean",
                            x=x, smooth=2, out=out)
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    line = fig.axes[0].get_lines()[0]
    xs, ys = line.get_data()
    ref = jplot.load_run(runs[0])
    np.testing.assert_array_equal(ys, jplot.ewma(ref["eval_return_mean"], 2))
    np.testing.assert_array_equal(xs, ref[f"eval_return_mean/{x}"])
    assert "no metrics.jsonl, skipped" in capsys.readouterr().out
    with pytest.raises(ValueError, match="x must be"):
        plot.compare_runs(runs, x="wall")
    with pytest.raises(ValueError, match="labels"):
        plot.compare_runs(runs, labels=["one"])


def test_plotting_cli_writes_a_png_and_loads_no_torch(tmp_path):
    run = _write_run(tmp_path / "run", 5)
    out = tmp_path / "cli.png"
    probe = ("import sys; from d4pg_tpu_torch.utils import plotting; "
             "plotting.main(sys.argv[1:]); "
             "assert 'torch' not in sys.modules, 'torch imported'")
    r = subprocess.run([sys.executable, "-c", probe, run, "--metric", "critic_loss",
                        "--smooth", "3", "--out", str(out)],
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert f"[plotting] wrote {out}" in r.stdout
    assert out.stat().st_size > 0
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert len([json.loads(x) for x in f]) == 16
