"""Plot generation (a copy of kafka_ps_tpu/evaluation/plots.py) — the
matplotlib port of the reference's two analysis notebooks
(evaluation/plot-generation.ipynb cells 0-10,
evaluation/evaluation-multipleDatasetsAtOnce.ipynb cells 0-9).

Per-run: loss / F1 / accuracy against wall-clock and tuples-seen.
Cross-run: consistency-model / event-frequency comparison of the F1
curves (the docs/plots/*.png family of the reference).
"""

from __future__ import annotations

import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import pandas as pd  # noqa: E402

from kafka_ps_tpu_torch.evaluation import logs as logs_mod  # noqa: E402


def plot_run(server_log: str, worker_log: str | None, out_path: str,
             title: str | None = None) -> str:
    """One run: metric curves vs wall-clock (and vs tuples-seen when a
    worker log is available)."""
    sdf = logs_mod.load_server_log(server_log)
    wdf = logs_mod.load_worker_log(worker_log) if worker_log else None
    ncols = 3 if wdf is not None else 2
    fig, axes = plt.subplots(1, ncols, figsize=(5 * ncols, 4))

    ax = axes[0]
    ax.plot(sdf["seconds"], sdf["fMeasure"], label="weighted F1")
    ax.plot(sdf["seconds"], sdf["accuracy"], label="accuracy")
    ax.set_xlabel("seconds")
    ax.set_ylabel("metric")
    ax.set_title("test metrics vs wall-clock")
    ax.legend()
    ax.grid(alpha=0.3)

    ax = axes[1]
    valid_loss = sdf[sdf["loss"] >= 0]
    ax.plot(valid_loss["seconds"], valid_loss["loss"], color="tab:red")
    ax.set_xlabel("seconds")
    ax.set_ylabel("test loss")
    ax.set_title("loss vs wall-clock")
    ax.grid(alpha=0.3)

    if wdf is not None:
        curve = logs_mod.tuples_seen_curve(wdf)
        ax = axes[2]
        ax.plot(curve["numTuplesSeen"], curve["fMeasure"], label="weighted F1")
        ax.plot(curve["numTuplesSeen"], curve["accuracy"], label="accuracy")
        ax.set_xlabel("tuples seen")
        ax.set_title("metrics vs tuples seen")
        ax.legend()
        ax.grid(alpha=0.3)

    fig.suptitle(title or os.path.basename(server_log))
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_comparison(named_server_logs: dict[str, str], out_path: str,
                    x: str = "seconds", title: str = "run comparison") -> str:
    """Overlayed F1 curves for several runs (consistency models, event
    frequencies, worker counts — the reference's comparison plots)."""
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for name, path in named_server_logs.items():
        sdf = logs_mod.load_server_log(path)
        ax1.plot(sdf[x], sdf["fMeasure"], label=name)
        ax2.plot(sdf[x], sdf["accuracy"], label=name)
    for ax, ylab in ((ax1, "weighted F1"), (ax2, "accuracy")):
        ax.set_xlabel(x)
        ax.set_ylabel(ylab)
        ax.legend()
        ax.grid(alpha=0.3)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_clock_spread(worker_log: str, out_path: str,
                      title: str | None = None) -> str:
    """Fastest-minus-slowest worker vector-clock spread over time — shows
    the staleness behavior of the three consistency models (README.md
    reports ~20-iteration spread for eventual, ≤k for bounded delay)."""
    wdf = logs_mod.load_worker_log(worker_log)
    spread = logs_mod.worker_clock_spread(wdf)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.step(spread["second_bucket"], spread["spread"], where="post")
    ax.set_xlabel("seconds")
    ax.set_ylabel("max − min worker vector clock")
    ax.set_title(title or "worker iteration spread")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def comparison_table(named_server_logs: dict[str, str]) -> pd.DataFrame:
    return logs_mod.compare_runs(named_server_logs)
