"""MovieLens ETL without pandas: raw `.dat` files -> train-ready tables.

Port of `xfmr_rec_tpu/data/prepare.py` with numpy and the standard
library only (no pandas, no pyarrow). The tables
are written as `.npz` files under `<data_dir>/ml-1m/prepared/`, names
the JAX package does not use, so both packages can share a `data_dir`:

- movies: movie_rn, movie_id, movie_text, is_train/is_val/is_test/
  is_predict;
- users: user_rn, user_id, user_text and the four flags;
- ratings: user_id, movie_id, rating, timestamp, the four flags,
  movie_rn, user_rn, hist_start, hist_stop, sorted by (user_id,
  timestamp), stably.

Semantics follow the reference step by step:
- `::`-separated latin-1 files; 1-based row numbers `movie_rn` /
  `user_rn` in file order; JSON feature text with
  `separators=(",", ":")`.
- The zipcode column goes through pandas' type inference in the
  reference: when every value parses as an integer the column comes back
  as int and `astype(str)` drops leading zeros ("01234" -> "1234"); one
  value that does not parse (e.g. "55455-1234") keeps every value as
  written. `load_users` reproduces that.
- Per-user temporal split: rank of the timestamp within the user
  (method "min", ties share the lowest rank), train iff rank / count <
  train_prop in float64; holdout users ranked by holdout count (method
  "min"), those at proportion >= 1 - val_prop are val, the rest test;
  predict is everyone.
- Open-interval rolling 4-week history ranges (t - 4w, t) into each
  user's time-sorted ratings.
- Movies are is_train when any of their ratings is; val/test/predict
  are True. A user's flags are the any() over its ratings (False for a
  user with no ratings).

Left out: the per-rating text columns (the texts live once in the movie
and user tables and join by row number) and the users' history/target
activity lists, which the batch pipeline never reads. Nothing is
downloaded: with no raw files the caller generates a synthetic corpus
(`data/synthetic.py`) or gets an error.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib

import numpy as np

logger = logging.getLogger(__name__)

FOUR_WEEKS_SECONDS = 4 * 7 * 24 * 3600
PREPARED_DIR = "prepared"
TABLES = ("movies", "users", "ratings")
FLAGS = ("is_train", "is_val", "is_test", "is_predict")

# Fingerprint of the real GroupLens ML-1M release (row counts and the
# first ratings line), to record provenance by measurement
_REAL_ML1M = {
    "num_ratings": 1_000_209,
    "num_users": 6_040,
    "num_movies": 3_883,
    "first_rating_line": "1::1193::5::978300760",
}


def raw_dir(src_dir: str | pathlib.Path) -> pathlib.Path:
    return pathlib.Path(src_dir, "ml-1m")


def prepared_path(src_dir: str | pathlib.Path, table: str) -> pathlib.Path:
    return raw_dir(src_dir) / PREPARED_DIR / f"{table}.npz"


# ---------------------------------------------------------------------------
# raw loaders
# ---------------------------------------------------------------------------
def _read_dat(path: pathlib.Path, num_cols: int) -> list[list[str]]:
    """`::`-split rows of a latin-1 file; blank lines are skipped."""
    rows = [
        line.split("::")
        for line in path.read_text(encoding="iso-8859-1").splitlines()
        if line
    ]
    for row in rows:
        if len(row) != num_cols:
            msg = f"{path}: expected {num_cols} fields, got {row!r}"
            raise ValueError(msg)
    return rows


def _int_or_none(value: str) -> int | None:
    try:
        return int(value)
    except ValueError:
        return None


def load_movies(src_dir: str | pathlib.Path) -> dict[str, np.ndarray]:
    rows = _read_dat(raw_dir(src_dir) / "movies.dat", 3)
    texts = [
        json.dumps(
            {"title": title, "genres": genres.split("|")},
            separators=(",", ":"),
        )
        for _, title, genres in rows
    ]
    return {
        "movie_rn": np.arange(1, len(rows) + 1, dtype=np.int64),
        "movie_id": np.array([int(r[0]) for r in rows], dtype=np.int64),
        "movie_text": np.array(texts, dtype=str),
    }


def load_users(src_dir: str | pathlib.Path) -> dict[str, np.ndarray]:
    rows = _read_dat(raw_dir(src_dir) / "users.dat", 5)
    zipcodes = [r[4] for r in rows]
    as_ints = [_int_or_none(z) for z in zipcodes]
    if rows and all(z is not None for z in as_ints):
        zipcodes = [str(z) for z in as_ints]
    texts = [
        json.dumps(
            {
                "gender": gender,
                "age": int(age),
                "occupation": int(occupation),
                "zipcode": zipcode,
            },
            separators=(",", ":"),
        )
        for (_, gender, age, occupation, _), zipcode in zip(
            rows, zipcodes, strict=True
        )
    ]
    return {
        "user_rn": np.arange(1, len(rows) + 1, dtype=np.int64),
        "user_id": np.array([int(r[0]) for r in rows], dtype=np.int64),
        "user_text": np.array(texts, dtype=str),
    }


def load_ratings(src_dir: str | pathlib.Path) -> dict[str, np.ndarray]:
    """ratings.dat -> user_id, movie_id, rating, timestamp (int64), in
    file order."""
    path = raw_dir(src_dir) / "ratings.dat"
    text = path.read_text(encoding="iso-8859-1")
    lines = sum(1 for line in text.splitlines() if line)
    values = np.fromstring(text.replace("::", " "), dtype=np.int64, sep=" ")
    if values.size != 4 * lines:
        msg = f"{path}: expected 4 integer fields on each of {lines} lines"
        raise ValueError(msg)
    values = values.reshape(lines, 4)
    names = ("user_id", "movie_id", "rating", "timestamp")
    return {name: values[:, col].copy() for col, name in enumerate(names)}


# ---------------------------------------------------------------------------
# split + feature generation
# ---------------------------------------------------------------------------
def _run_starts(changed: np.ndarray) -> np.ndarray:
    """Each element's index of the first element of its run, where
    `changed[i]` says element i + 1 starts a new run."""
    new_run = np.r_[True, changed]
    return np.maximum.accumulate(np.where(new_run, np.arange(len(new_run)), 0))


def train_test_split(
    ratings: dict[str, np.ndarray],
    *,
    train_prop: float = 0.8,
    val_prop: float = 0.2,
) -> dict[str, np.ndarray]:
    """Per-user temporal split + the val/test partition of the holdout
    users; adds the four flag columns (file order kept)."""
    user = ratings["user_id"]
    order = np.lexsort((ratings["timestamp"], user))
    user_s = user[order]
    ts_s = ratings["timestamp"][order]
    new_user = user_s[1:] != user_s[:-1]
    new_time = ts_s[1:] != ts_s[:-1]
    # pandas rank(method="min") - 1: the first of a run of equal times
    rank = _run_starts(new_user | new_time) - _run_starts(new_user)
    _, inverse, counts = np.unique(
        user_s, return_inverse=True, return_counts=True
    )
    is_train_s = (rank / counts[inverse]) < train_prop
    is_train = np.empty(len(order), dtype=bool)
    is_train[order] = is_train_s

    holdout_users, holdout_counts = np.unique(
        user[~is_train], return_counts=True
    )
    if len(holdout_counts):
        below = np.searchsorted(
            np.sort(holdout_counts), holdout_counts, side="left"
        )
        proportion = below / len(holdout_counts)
        val_users = holdout_users[proportion >= 1 - val_prop]
    else:
        val_users = holdout_users
    in_val = np.isin(user, val_users)
    return {
        **ratings,
        "is_train": is_train,
        "is_val": ~is_train & in_val,
        "is_test": ~is_train & ~in_val,
        "is_predict": np.ones(len(user), dtype=bool),
    }


def rolling_history_ranges(
    timestamps: np.ndarray, window_seconds: int = FOUR_WEEKS_SECONDS
) -> tuple[np.ndarray, np.ndarray]:
    """Index ranges [start, stop) into a sorted time array of the events
    strictly inside (t - window, t) for each event t."""
    start = np.searchsorted(timestamps, timestamps - window_seconds, "right")
    stop = np.searchsorted(timestamps, timestamps, "left")
    return start, stop


def lookup_positions(
    ids: np.ndarray, table_ids: np.ndarray, what: str
) -> np.ndarray:
    """Positions of `ids` in `table_ids` (which need not be sorted)."""
    sorter = np.argsort(table_ids, kind="stable")
    pos = np.searchsorted(table_ids, ids, sorter=sorter)
    pos = np.minimum(pos, len(table_ids) - 1)
    found = sorter[pos]
    if len(ids) and (len(table_ids) == 0 or (table_ids[found] != ids).any()):
        msg = f"ratings reference {what} ids missing from the {what} table"
        raise ValueError(msg)
    return found


def process_ratings(
    ratings: dict[str, np.ndarray],
    users: dict[str, np.ndarray],
    movies: dict[str, np.ndarray],
) -> dict[str, np.ndarray]:
    """Sort by (user_id, timestamp) stably; attach row numbers and the
    rolling history ranges."""
    order = np.lexsort((ratings["timestamp"], ratings["user_id"]))
    out = {name: column[order] for name, column in ratings.items()}
    out["movie_rn"] = movies["movie_rn"][
        lookup_positions(out["movie_id"], movies["movie_id"], "movie")
    ]
    out["user_rn"] = users["user_rn"][
        lookup_positions(out["user_id"], users["user_id"], "user")
    ]
    starts = np.zeros(len(order), dtype=np.int64)
    stops = np.zeros(len(order), dtype=np.int64)
    bounds = np.flatnonzero(np.diff(out["user_id"]) != 0) + 1
    for lo, hi in zip(
        np.r_[0, bounds], np.r_[bounds, len(order)], strict=True
    ):
        if hi > lo:
            s, e = rolling_history_ranges(out["timestamp"][lo:hi])
            starts[lo:hi] = s + lo
            stops[lo:hi] = e + lo
    out["hist_start"] = starts
    out["hist_stop"] = stops
    return out


def _flags_by_id(
    ids: np.ndarray, rating_ids: np.ndarray, flags: dict[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """any() of each flag over the ratings of each id (False for none)."""
    out = {}
    for name, column in flags.items():
        out[name] = np.isin(ids, rating_ids[column])
    return out


def process_movies(
    movies: dict[str, np.ndarray], ratings: dict[str, np.ndarray]
) -> dict[str, np.ndarray]:
    num = len(movies["movie_id"])
    return {
        **movies,
        **_flags_by_id(
            movies["movie_id"],
            ratings["movie_id"],
            {"is_train": ratings["is_train"]},
        ),
        "is_val": np.ones(num, dtype=bool),
        "is_test": np.ones(num, dtype=bool),
        "is_predict": np.ones(num, dtype=bool),
    }


def process_users(
    users: dict[str, np.ndarray], ratings: dict[str, np.ndarray]
) -> dict[str, np.ndarray]:
    return {
        **users,
        **_flags_by_id(
            users["user_id"],
            ratings["user_id"],
            {name: ratings[name] for name in FLAGS},
        ),
    }


def _save_table(path: pathlib.Path, columns: dict[str, np.ndarray]) -> None:
    """Write then rename, so a reader never sees half a table."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with tmp.open("wb") as fh:
        np.savez(fh, **columns)
    os.replace(tmp, path)


def load_table(
    src_dir: str | pathlib.Path, table: str
) -> dict[str, np.ndarray]:
    with np.load(prepared_path(src_dir, table), allow_pickle=False) as npz:
        return {name: npz[name] for name in npz.files}


def prepared(src_dir: str | pathlib.Path) -> bool:
    return all(prepared_path(src_dir, t).exists() for t in TABLES)


def prepare_movielens(
    src_dir: str | pathlib.Path, *, overwrite: bool = False
) -> None:
    """Run the ETL once: raw files -> the three prepared tables (kept as
    they are unless `overwrite`)."""
    if prepared(src_dir) and not overwrite:
        return
    movies = load_movies(src_dir)
    users = load_users(src_dir)
    ratings = process_ratings(
        train_test_split(load_ratings(src_dir)), users, movies
    )
    tables = {
        "movies": process_movies(movies, ratings),
        "users": process_users(users, ratings),
        "ratings": ratings,
    }
    for name, columns in tables.items():
        _save_table(prepared_path(src_dir, name), columns)
        logger.info(
            "%s saved: %d rows", name, len(next(iter(columns.values())))
        )


def record_provenance(src_dir: str | pathlib.Path, source: str) -> dict:
    """Record where the raw corpus came from, with a measured check
    against the real ML-1M fingerprint, in `prepared/provenance.json`."""
    raw = raw_dir(src_dir)

    def count_lines(name: str) -> int:
        path = raw / name
        if not path.exists():
            return 0
        with path.open("rb") as fh:
            return sum(1 for _ in fh)

    first_line = ""
    ratings_path = raw / "ratings.dat"
    if ratings_path.exists():
        with ratings_path.open(encoding="iso-8859-1") as fh:
            first_line = fh.readline().strip()
    counts = {
        "num_ratings": count_lines("ratings.dat"),
        "num_users": count_lines("users.dat"),
        "num_movies": count_lines("movies.dat"),
    }
    matches = (
        all(counts[key] == _REAL_ML1M[key] for key in counts)
        and first_line == _REAL_ML1M["first_rating_line"]
    )
    record = {
        "source": source,
        **counts,
        "raw_files_present": ratings_path.exists(),
        "matches_real_ml1m": matches,
        "dataset_label": (
            "MovieLens-1M" if matches else f"synthetic-ML1M ({source})"
        ),
    }
    path = raw / PREPARED_DIR / "provenance.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=2))
    return record
