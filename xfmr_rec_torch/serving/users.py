"""The user store: profiles and time-sorted activity lists, without parquet.

The reference keeps each user's `history` (train-half ratings) and
`target` (holdout ratings) as lists of {datetime, rating, movie_rn,
movie_id, movie_text} in `users.parquet`. The port reads no parquet, so
`Trainer.save` writes the same content as `users.npz`: the user table
(`user_id`, `user_rn`, `user_text`), a movie table (`movie_id`,
`movie_text`) that the activities join to by position, and for each of
`history` / `target` CSR offsets (one row a user) into flat activity
columns in time order. `from_tables` builds it from the port's prepared
tables; `from_rows` from records shaped like the reference's
`users.parquet` rows (a JAX artifact's store, read with pandas, converts
this way). `get` returns the `UserQuery` the reference engine builds.
"""

from __future__ import annotations

import pathlib
from collections.abc import Iterable

import numpy as np

from xfmr_rec_torch.data.prepare import load_table, lookup_positions
from xfmr_rec_torch.serving.schemas import Activity, NotFoundError, UserQuery

ACTIVITIES = ("history", "target")
_COLUMNS = ("datetime", "rating", "movie_rn", "movie_id", "movie_pos")


class UserStore:
    """User profiles + activity lists (see the module docstring)."""

    def __init__(self, arrays: dict[str, np.ndarray]) -> None:
        self.arrays = arrays
        self._pos_of_id = {
            int(user_id): pos for pos, user_id in enumerate(arrays["user_id"])
        }

    def __len__(self) -> int:
        return len(self.arrays["user_id"])

    # -- construction ------------------------------------------------------
    @classmethod
    def from_tables(
        cls,
        users: dict[str, np.ndarray],
        ratings: dict[str, np.ndarray],
        movies: dict[str, np.ndarray],
    ) -> UserStore:
        """From the prepared tables (`data/prepare.py`): a user's history
        is its train ratings, its target the rest, each in the ratings
        table's (user_id, timestamp) order."""
        user_pos = lookup_positions(ratings["user_id"], users["user_id"], "user")
        movie_pos = lookup_positions(
            ratings["movie_id"], movies["movie_id"], "movie"
        )
        arrays = {
            "user_id": users["user_id"].astype(np.int64),
            "user_rn": users["user_rn"].astype(np.int64),
            "user_text": users["user_text"],
            "movie_id": movies["movie_id"].astype(np.int64),
            "movie_text": movies["movie_text"],
        }
        columns = {
            "datetime": ratings["timestamp"],
            "rating": ratings["rating"],
            "movie_rn": ratings["movie_rn"],
            "movie_id": ratings["movie_id"],
            "movie_pos": movie_pos,
        }
        for name, rows in (
            ("history", ratings["is_train"]),
            ("target", ~ratings["is_train"]),
        ):
            order = np.flatnonzero(rows)
            order = order[np.argsort(user_pos[order], kind="stable")]
            counts = np.bincount(
                user_pos[order], minlength=len(users["user_id"])
            )
            arrays[f"{name}_offsets"] = np.r_[0, np.cumsum(counts)].astype(
                np.int64
            )
            for column, values in columns.items():
                arrays[f"{name}_{column}"] = values[order].astype(np.int64)
        return cls(arrays)

    @classmethod
    def from_prepared(cls, data_dir: str | pathlib.Path) -> UserStore:
        return cls.from_tables(
            load_table(data_dir, "users"),
            load_table(data_dir, "ratings"),
            load_table(data_dir, "movies"),
        )

    @classmethod
    def from_rows(cls, rows: Iterable[dict]) -> UserStore:
        """From records with `user_id`, `user_rn`, `user_text`, `history`
        and `target` (lists of activity mappings), as the rows of the
        reference's `users.parquet`."""
        movie_pos: dict[int, int] = {}
        movie_text: list[str] = []
        users = {"user_id": [], "user_rn": [], "user_text": []}
        acts = {
            name: {"offsets": [0], **{c: [] for c in _COLUMNS}}
            for name in ACTIVITIES
        }
        for row in rows:
            for key in users:
                users[key].append(row[key])
            for name in ACTIVITIES:
                entries = row.get(name)
                entries = [] if entries is None else list(entries)
                for entry in entries:
                    movie_id = int(entry["movie_id"])
                    if movie_id not in movie_pos:
                        movie_pos[movie_id] = len(movie_text)
                        movie_text.append(str(entry["movie_text"]))
                    out = acts[name]
                    out["datetime"].append(int(entry["datetime"]))
                    out["rating"].append(int(entry["rating"]))
                    out["movie_rn"].append(int(entry["movie_rn"]))
                    out["movie_id"].append(movie_id)
                    out["movie_pos"].append(movie_pos[movie_id])
                acts[name]["offsets"].append(
                    acts[name]["offsets"][-1] + len(entries)
                )
        arrays = {
            "user_id": np.asarray(users["user_id"], np.int64),
            "user_rn": np.asarray(users["user_rn"], np.int64),
            "user_text": np.asarray(users["user_text"], dtype=str),
            "movie_id": np.asarray(list(movie_pos), np.int64),
            "movie_text": np.asarray(movie_text, dtype=str),
        }
        for name, columns in acts.items():
            for column, values in columns.items():
                arrays[f"{name}_{column}"] = np.asarray(values, np.int64)
        return cls(arrays)

    # -- files -------------------------------------------------------------
    def save(self, path: str | pathlib.Path) -> None:
        np.savez(path, **self.arrays)

    @classmethod
    def load(cls, path: str | pathlib.Path) -> UserStore:
        with np.load(path, allow_pickle=False) as npz:
            return cls({name: npz[name] for name in npz.files})

    # -- lookups -----------------------------------------------------------
    def activities(self, user_id: int, name: str) -> list[Activity]:
        """One user's `history` or `target`, in time order."""
        a = self.arrays
        pos = self._position(user_id)
        lo, hi = a[f"{name}_offsets"][pos : pos + 2]
        return [
            Activity(
                datetime=int(a[f"{name}_datetime"][i]),
                rating=int(a[f"{name}_rating"][i]),
                movie_rn=int(a[f"{name}_movie_rn"][i]),
                movie_id=int(a[f"{name}_movie_id"][i]),
                movie_text=str(a["movie_text"][a[f"{name}_movie_pos"][i]]),
            )
            for i in range(lo, hi)
        ]

    def get(self, user_id: int) -> UserQuery:
        pos = self._position(user_id)
        a = self.arrays
        return UserQuery(
            user_rn=int(a["user_rn"][pos]),
            user_id=int(a["user_id"][pos]),
            user_text=str(a["user_text"][pos]),
            history=self.activities(user_id, "history"),
            target=self.activities(user_id, "target"),
        )

    def _position(self, user_id: int) -> int:
        pos = self._pos_of_id.get(int(user_id))
        if pos is None:
            msg = f"user not found: {user_id=}"
            raise NotFoundError(msg)
        return pos
