"""CSV log parsing + derived run statistics (a copy of
kafka_ps_tpu/evaluation/logs.py: pandas on the host, no torch).

The reference's notebooks load `logs-server.csv` / `logs-worker.csv`
(semicolon-separated, schema ServerAppRunner.java:81 /
WorkerAppRunner.java:80) and derive loss/F1/accuracy curves over time and
tuples-seen.  This module reproduces those derivations — plus the summary
columns SURVEY §6 computes from the committed logs (duration, iters/s,
best F1, wall-clock-to-F1-target) — so runs of this framework and the
reference's own committed logs are comparable with the same code.
"""

from __future__ import annotations

import dataclasses

import pandas as pd

SERVER_COLUMNS = ["timestamp", "partition", "vectorClock", "loss",
                  "fMeasure", "accuracy"]
WORKER_COLUMNS = SERVER_COLUMNS + ["numTuplesSeen"]
# drift verdict log (utils/csvlog.DRIFT_HEADER, written by the CLI's
# wall-clock-stamping sink around telemetry/drift.py): one row per
# warn/trip edge
DRIFT_COLUMNS = ["timestamp", "event", "detector", "statistic", "signal"]


def _load(path: str, columns: list[str]) -> pd.DataFrame:
    df = pd.read_csv(path, sep=";")
    missing = [c for c in columns if c not in df.columns]
    if missing:
        raise ValueError(f"{path}: missing log columns {missing} "
                         f"(have {list(df.columns)})")
    df = df[columns].apply(pd.to_numeric, errors="coerce")
    df = df.dropna(subset=["timestamp", "vectorClock"])
    # relative seconds since run start (notebooks plot against this)
    if len(df):
        df["seconds"] = (df["timestamp"] - df["timestamp"].iloc[0]) / 1000.0
    else:
        df["seconds"] = pd.Series(dtype=float)
    return df.reset_index(drop=True)


def load_server_log(path: str) -> pd.DataFrame:
    return _load(path, SERVER_COLUMNS)


def load_worker_log(path: str) -> pd.DataFrame:
    return _load(path, WORKER_COLUMNS)


def load_drift_log(path: str) -> pd.DataFrame:
    """Load a `logs-drift.csv` (--model-health -l): warn/trip verdict
    rows with numeric timestamp/statistic and derived relative seconds.
    `event`/`detector`/`signal` stay categorical strings."""
    df = pd.read_csv(path, sep=";")
    missing = [c for c in DRIFT_COLUMNS if c not in df.columns]
    if missing:
        raise ValueError(f"{path}: missing drift columns {missing} "
                         f"(have {list(df.columns)})")
    df = df[DRIFT_COLUMNS].copy()
    for c in ("timestamp", "statistic"):
        df[c] = pd.to_numeric(df[c], errors="coerce")
    df = df.dropna(subset=["timestamp"])
    if len(df):
        df["seconds"] = (df["timestamp"] - df["timestamp"].iloc[0]) / 1000.0
    else:
        df["seconds"] = pd.Series(dtype=float)
    return df.reset_index(drop=True)


def with_drift_events(server_df: pd.DataFrame,
                      drift_df: pd.DataFrame) -> pd.DataFrame:
    """Join the drift verdicts onto the server eval curve: adds a
    `drift_events` column — the cumulative count of drift TRIPS at or
    before each eval row's timestamp — so a loss/F1 plot can mark
    where the detectors fired.  An empty drift log yields all zeros."""
    out = server_df.copy()
    trips = drift_df.loc[drift_df["event"] == "trip", "timestamp"]
    trip_ts = trips.sort_values().to_numpy()
    if len(trip_ts) == 0:
        out["drift_events"] = 0
        return out
    import numpy as np
    out["drift_events"] = np.searchsorted(
        trip_ts, out["timestamp"].to_numpy(), side="right")
    return out


@dataclasses.dataclass(frozen=True)
class RunSummary:
    """The derived columns of SURVEY §6 / BASELINE.md for one run."""

    duration_s: float          # last − first server timestamp
    iterations: int            # max vector clock seen by the server
    iters_per_sec: float | None   # None on zero-duration (degenerate) logs
    best_f1: float
    best_accuracy: float
    final_loss: float
    secs_to_f1: dict[float, float | None]   # target -> wall-clock seconds
    worker_updates_per_sec: float | None = None   # aggregate, worker log

    def row(self) -> dict:
        out = dataclasses.asdict(self)
        out.update({f"secs_to_f1_{t:g}": v
                    for t, v in out.pop("secs_to_f1").items()})
        return out


def summarize_run(server_df: pd.DataFrame,
                  worker_df: pd.DataFrame | None = None,
                  f1_targets: tuple[float, ...] = (0.40, 0.44)) -> RunSummary:
    if not len(server_df):
        raise ValueError("empty server log — run produced no iterations")
    duration = float(server_df["seconds"].iloc[-1])
    iterations = int(server_df["vectorClock"].max())
    secs_to = {}
    for t in f1_targets:
        hit = server_df.loc[server_df["fMeasure"] >= t, "seconds"]
        secs_to[t] = float(hit.iloc[0]) if len(hit) else None
    wups = None
    if worker_df is not None and len(worker_df) > 1:
        span = float(worker_df["seconds"].iloc[-1])
        wups = (len(worker_df) / span) if span > 0 else None
    return RunSummary(
        duration_s=duration,
        iterations=iterations,
        iters_per_sec=iterations / duration if duration > 0 else None,
        best_f1=float(server_df["fMeasure"].max()),
        best_accuracy=float(server_df["accuracy"].max()),
        final_loss=float(server_df["loss"].iloc[-1]),
        secs_to_f1=secs_to,
        worker_updates_per_sec=wups,
    )


def compare_runs(named_server_logs: dict[str, str]) -> pd.DataFrame:
    """Cross-run table (evaluation-multipleDatasetsAtOnce.ipynb): one row
    per run config with the §6 derived columns."""
    rows = []
    for name, path in named_server_logs.items():
        s = summarize_run(load_server_log(path))
        rows.append({"run": name, **s.row()})
    return pd.DataFrame(rows)


def tuples_seen_curve(worker_df: pd.DataFrame) -> pd.DataFrame:
    """F1/accuracy against cumulative tuples seen (the x-axis the
    reference's per-run plots use for the streaming-progress view)."""
    g = worker_df.groupby("vectorClock").agg(
        numTuplesSeen=("numTuplesSeen", "max"),
        fMeasure=("fMeasure", "mean"),
        accuracy=("accuracy", "mean"),
        loss=("loss", "mean"),
        seconds=("seconds", "max"),
    )
    return g.reset_index().sort_values("vectorClock")


def worker_clock_spread(worker_df: pd.DataFrame) -> pd.DataFrame:
    """Fastest-vs-slowest worker iteration gap over time — the metric the
    reference uses to characterize eventual consistency (README.md:316-323:
    ~20-iteration gap under `-c -1`).

    Per second bucket: each worker's latest vector clock, then max − min
    across workers (not across raw rows — a single fast worker logging
    several clocks within one second is progression, not staleness)."""
    df = worker_df.copy()
    df["second_bucket"] = df["seconds"].astype(int)
    latest = df.groupby(["second_bucket", "partition"])["vectorClock"].max()
    g = latest.groupby("second_bucket").agg(["min", "max"])
    g["spread"] = g["max"] - g["min"]
    return g.reset_index()
