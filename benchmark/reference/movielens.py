"""A seeded MovieLens-1M-like corpus, and its texts as the recommender reads them.

The generator writes `movies.dat`, `users.dat` and `ratings.dat` in the
ml-1m format (`::`-separated, latin-1) with the planted structure of the
recommender's own synthetic generator: movies and users fall into latent
archetypes, each archetype prefers three genres, a user's ratings pick an
archetype-matched movie 70 % of the time (rated 3-5) and another otherwise
(rated 1-3), and activity per user is heavy-tailed (Pareto, shape 2). It
draws in bulk with numpy, so the same seed gives the same files, but not
the recommender generator's files.

The texts are the recommender's: a movie is `{"title":..,"genres":[..]}`
and a user `{"gender":..,"age":..,"occupation":..,"zipcode":..}`, compact
JSON.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

GENRES = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]
ADJECTIVES = [
    "Lost", "Silent", "Golden", "Midnight", "Broken", "Electric", "Hidden",
    "Crimson", "Frozen", "Burning", "Distant", "Savage", "Gentle", "Iron",
]
NOUNS = [
    "City", "River", "Dream", "Empire", "Garden", "Shadow", "Horizon",
    "Island", "Star", "Road", "Heart", "Storm", "Castle", "Ocean",
]
AGES = [1, 18, 25, 35, 45, 50, 56]
OCCUPATIONS = 21
ARCHETYPES = 4
BASE_TIMESTAMP = 956_700_000


def movie_text(title: str, genres: list[str]) -> str:
    return json.dumps({"title": title, "genres": genres}, separators=(",", ":"))


def user_text(gender: str, age: int, occupation: int, zipcode: str) -> str:
    return json.dumps(
        {"gender": gender, "age": age, "occupation": occupation,
         "zipcode": zipcode},
        separators=(",", ":"),
    )


class Catalogue:
    """Seeded movies and users: titles, genres, archetypes, user fields."""

    def __init__(self, rng: np.random.Generator, movies: int, users: int):
        self.movie_arch = rng.integers(0, ARCHETYPES, movies)
        self.user_arch = rng.integers(0, ARCHETYPES, users)
        arch_genres = [rng.choice(len(GENRES), 3, replace=False)
                       for _ in range(ARCHETYPES)]
        adj = rng.integers(0, len(ADJECTIVES), movies)
        noun = rng.integers(0, len(NOUNS), movies)
        year = 1970 + rng.integers(0, 31, movies)
        count = 1 + rng.integers(0, 3, movies)
        self.titles = [
            f"{ADJECTIVES[a]} {NOUNS[b]} {i + 1} ({y})"
            for i, (a, b, y) in enumerate(zip(adj.tolist(), noun.tolist(),
                                              year.tolist(), strict=True))
        ]
        self.genres = [
            [GENRES[g] for g in arch_genres[arch][:c]]
            for arch, c in zip(self.movie_arch.tolist(), count.tolist(),
                               strict=True)
        ]
        self.gender = rng.choice(np.array(["M", "F"]), users)
        self.age = np.asarray(AGES)[rng.integers(0, len(AGES), users)]
        self.occupation = rng.integers(0, OCCUPATIONS, users)
        self.zipcode = rng.integers(10000, 99999, users)

    def movie_texts(self) -> list[str]:
        # compact JSON written directly: the same bytes as `movie_text`
        quoted = {}
        out = []
        for title, genres in zip(self.titles, self.genres, strict=True):
            key = tuple(genres)
            if key not in quoted:
                quoted[key] = json.dumps(genres, separators=(",", ":"))
            out.append(f'{{"title":"{title}","genres":{quoted[key]}}}')
        return out

    def user_texts(self) -> list[str]:
        return [
            user_text(str(g), int(a), int(o), str(z))
            for g, a, o, z in zip(self.gender, self.age, self.occupation,
                                  self.zipcode, strict=True)
        ]


def ratings(
    rng: np.random.Generator, catalogue: Catalogue, wanted: int
) -> np.ndarray:
    """(n, 4) int64 rows user_id, movie_id, rating, timestamp, ordered by
    user then time, each (user, movie) pair once."""
    users = len(catalogue.user_arch)
    movies = len(catalogue.movie_arch)
    mean = max(4, wanted // users)
    counts = 4 + (rng.pareto(2.0, users) * mean).astype(np.int64)
    counts = np.minimum(counts, min(4 * mean, movies // 2))
    user = np.repeat(np.arange(users), counts)
    matched = rng.random(len(user)) < 0.7
    by_arch = [np.flatnonzero(catalogue.movie_arch == a)
               for a in range(ARCHETYPES)]
    other = [np.flatnonzero(catalogue.movie_arch != a)
             for a in range(ARCHETYPES)]
    movie = np.empty(len(user), np.int64)
    arch = catalogue.user_arch[user]
    draw = rng.random(len(user))
    for a in range(ARCHETYPES):
        for pick, pool in ((matched, by_arch[a]), (~matched, other[a])):
            rows = np.flatnonzero((arch == a) & pick)
            movie[rows] = pool[(draw[rows] * len(pool)).astype(np.int64)]
    rating = np.where(matched, rng.integers(3, 6, len(user)),
                      rng.integers(1, 4, len(user)))
    _, first = np.unique(user * movies + movie, return_index=True)
    keep = np.sort(first)
    user, movie, rating = user[keep], movie[keep], rating[keep]
    step = rng.integers(60, 200_000, len(user))
    start = BASE_TIMESTAMP + rng.integers(0, 10_000_000, users)
    # each user's times step forward from their start, from their first row
    total = np.cumsum(step)
    first = np.r_[0, np.flatnonzero(np.diff(user)) + 1]
    run = np.cumsum(np.r_[0, np.diff(user) != 0])
    time = start[user] + total - total[first][run] + step[first][run]
    return np.stack([user + 1, movie + 1, rating, time], axis=1)


def write_ml1m(
    dest: pathlib.Path, seed: int, movies: int, users: int, wanted: int
) -> pathlib.Path:
    """Write the corpus under `dest`/ml-1m/; returns that directory."""
    rng = np.random.default_rng(seed)
    catalogue = Catalogue(rng, movies, users)
    rows = ratings(rng, catalogue, wanted)
    out = pathlib.Path(dest, "ml-1m")
    out.mkdir(parents=True, exist_ok=True)
    (out / "movies.dat").write_text(
        "".join(
            f"{i + 1}::{t}::{'|'.join(g)}\n"
            for i, (t, g) in enumerate(zip(catalogue.titles, catalogue.genres,
                                           strict=True))
        ),
        encoding="iso-8859-1",
    )
    (out / "users.dat").write_text(
        "".join(
            f"{i + 1}::{g}::{a}::{o}::{z}\n"
            for i, (g, a, o, z) in enumerate(zip(
                catalogue.gender, catalogue.age, catalogue.occupation,
                catalogue.zipcode, strict=True))
        ),
        encoding="iso-8859-1",
    )
    (out / "ratings.dat").write_text(
        "".join(f"{u}::{m}::{r}::{t}\n" for u, m, r, t in rows.tolist()),
        encoding="iso-8859-1",
    )
    return out


def read_ml1m(src: pathlib.Path) -> dict:
    """The corpus as the recommender reads it: movie and user texts by id,
    and every (user_id, movie_id, rating) rated."""
    src = pathlib.Path(src, "ml-1m")

    def lines(name):
        text = (src / name).read_text(encoding="iso-8859-1")
        return [line.split("::") for line in text.splitlines() if line]

    movies = {int(m): movie_text(title, genres.split("|"))
              for m, title, genres in lines("movies.dat")}
    users = {int(u): user_text(g, int(a), int(o), str(int(z)))
             for u, g, a, o, z in lines("users.dat")}
    rated = {(int(u), int(m), int(r)) for u, m, r, _ in lines("ratings.dat")}
    return {"movies": movies, "users": users, "rated": rated}
