"""Offline plotting and run analysis (the port's copy of
``d4pg_tpu/utils/plotting.py``).

- :func:`ewma`: the EWMA smoothing of a score curve (α = 2/(window+1),
  seeded at the first value), by the stable recurrence
  ``y[t] = (1-α)·y[t-1] + α·x[t]`` rather than explicit ``(1-α)^n``
  powers, which under- and overflow on long runs;
- :func:`load_run`: one run directory's ``metrics.jsonl`` (what every
  training run of the port writes, ``runtime/metrics.py``) as column
  arrays, so analysis needs no logging path of its own;
- :func:`plot_run` / :func:`compare_runs`: any scalar of one run or
  overlaid across runs, against grad steps or wall-clock seconds, as a PNG.

matplotlib is imported when a figure is drawn, never by the training
path; the machine with the card has none, so plots are drawn on a host.

CLI::

    python -m d4pg_tpu_torch.utils.plotting runs/* --metric eval_return_mean \\
        --x step --smooth 20 --out compare.png
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np


def ewma(data: np.ndarray, window: int) -> np.ndarray:
    """Exponentially weighted moving average with span ``window``
    (α = 2/(window+1), seeded at ``data[0]``), in float64."""
    data = np.asarray(data, np.float64)
    if data.ndim != 1:
        raise ValueError(f"ewma expects 1-D data, got shape {data.shape}")
    if window < 1:
        raise ValueError(f"ewma window must be >= 1, got {window}")
    if data.size == 0:
        return data.copy()
    alpha = 2.0 / (window + 1.0)
    out = np.empty_like(data)
    out[0] = data[0]
    for t in range(1, data.size):
        out[t] = (1.0 - alpha) * out[t - 1] + alpha * data[t]
    return out


def load_run(log_dir: str) -> Dict[str, np.ndarray]:
    """One run's ``metrics.jsonl`` as column arrays.

    Rows may carry different keys (train rows, eval rows); each scalar
    becomes three arrays: ``<name>`` (the values), ``<name>/step`` and
    ``<name>/t`` (the grad step and the wall-clock second of each).
    """
    path = os.path.join(log_dir, "metrics.jsonl")
    rows: List[Mapping[str, float]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    columns: Dict[str, List[float]] = {}
    for row in rows:
        step = row.get("step", 0)
        t = row.get("t", 0.0)
        for key, value in row.items():
            if key in ("step", "t"):
                continue
            columns.setdefault(key, []).append(float(value))
            columns.setdefault(f"{key}/step", []).append(float(step))
            columns.setdefault(f"{key}/t", []).append(float(t))
    return {k: np.asarray(v) for k, v in columns.items()}


def available_metrics(run: Mapping[str, np.ndarray]) -> List[str]:
    return sorted(k for k in run if "/" not in k)


def plot_run(
    log_dir: str,
    metric: str = "eval_return_mean",
    x: str = "step",
    smooth: int = 20,
    out: Optional[str] = None,
    title: Optional[str] = None,
):
    """One run's score curve."""
    return compare_runs([log_dir], metric=metric, x=x, smooth=smooth, out=out, title=title)


def compare_runs(
    log_dirs: Sequence[str],
    metric: str = "eval_return_mean",
    x: str = "step",
    smooth: int = 20,
    out: Optional[str] = None,
    title: Optional[str] = None,
    labels: Optional[Sequence[str]] = None,
):
    """``metric`` of several runs overlaid against ``x`` ("step" or "t").

    ``eval_return_mean`` is the raw score of each eval (smooth it here);
    ``avg_test_reward_ewma`` is smoothed already (pass ``smooth=0``).
    Returns the matplotlib figure and saves a PNG when ``out`` is given;
    a run without ``metrics.jsonl`` or without the metric is skipped with
    a line saying so.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if x not in ("step", "t"):
        raise ValueError(f"x must be 'step' or 't', got {x!r}")
    if labels is not None and len(labels) != len(log_dirs):
        raise ValueError(f"{len(labels)} labels for {len(log_dirs)} run dirs")
    labels = list(labels) if labels is not None else [
        os.path.basename(os.path.normpath(d)) for d in log_dirs
    ]
    fig, ax = plt.subplots(figsize=(8, 5))
    plotted = 0
    for log_dir, label in zip(log_dirs, labels):
        try:
            run = load_run(log_dir)
        except (FileNotFoundError, NotADirectoryError):
            print(f"[plotting] {log_dir}: no metrics.jsonl, skipped")
            continue
        if metric not in run:
            print(f"[plotting] {log_dir}: no metric {metric!r} (has {available_metrics(run)})")
            continue
        ys = run[metric]
        xs = run[f"{metric}/{x}"]
        if smooth and ys.size > 2:
            ys = ewma(ys, smooth)
        ax.plot(xs, ys, label=label)
        plotted += 1
    ax.set_xlabel("grad steps" if x == "step" else "wall-clock (s)")
    ax.set_ylabel(metric)
    ax.set_title(title or f"{metric} vs {'steps' if x == 'step' else 'time'}")
    if plotted > 1:
        ax.legend(fontsize=8)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=120)
        print(f"[plotting] wrote {out}")
    return fig


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="python -m d4pg_tpu_torch.utils.plotting",
                                description="Plot or compare d4pg_tpu_torch runs")
    p.add_argument("log_dirs", nargs="+", help="run directories (metrics.jsonl inside)")
    p.add_argument("--metric", default="eval_return_mean")
    p.add_argument("--x", choices=["step", "t"], default="step")
    p.add_argument("--smooth", type=int, default=20)
    p.add_argument("--out", default="compare.png")
    p.add_argument("--title", default=None)
    args = p.parse_args(argv)
    compare_runs(args.log_dirs, metric=args.metric, x=args.x, smooth=args.smooth,
                 out=args.out, title=args.title)


if __name__ == "__main__":
    main()
