"""Synthetic MovieLens-compatible corpus generator.

Own numpy-only copy of `xfmr_rec_tpu/data/synthetic.py`: the same seed
gives byte-identical `movies.dat` / `users.dat` / `ratings.dat` in the
ml-1m format (``::``-separated, latin-1), so the ETL -> pipeline ->
training stack runs without the real corpus, at any scale.

The generator plants low-rank structure: users and movies get latent
archetypes, and rating probability follows archetype affinity, so a
trained model has real signal to learn and retrieval metrics move above
chance.
"""

from __future__ import annotations

import pathlib

import numpy as np

GENRES = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]
_ADJECTIVES = [
    "Lost", "Silent", "Golden", "Midnight", "Broken", "Electric", "Hidden",
    "Crimson", "Frozen", "Burning", "Distant", "Savage", "Gentle", "Iron",
]
_NOUNS = [
    "City", "River", "Dream", "Empire", "Garden", "Shadow", "Horizon",
    "Island", "Star", "Road", "Heart", "Storm", "Castle", "Ocean",
]
_OCCUPATION_COUNT = 21
_AGES = [1, 18, 25, 35, 45, 50, 56]
_BASE_TIMESTAMP = 956_700_000  # ~2000-04, matches the ml-1m era


def generate_movielens(
    dest_dir: str | pathlib.Path,
    *,
    num_users: int = 120,
    num_movies: int = 200,
    num_ratings: int = 4000,
    num_archetypes: int = 4,
    seed: int = 0,
    text_signal: bool = False,
) -> pathlib.Path:
    """Write synthetic .dat files under `dest_dir`/ml-1m/. Returns that dir.

    `text_signal=True` makes user ATTRIBUTES predictive of the user's
    latent archetype (occupation/age/gender drawn conditioned on it, 80%
    concentration) — without it the user profile text carries ZERO
    preference information, so text-tower quality is capped at the
    popularity/itemCF ceiling by construction (the round-4 finding:
    flagship val NDCG saturated exactly at the non-learned ceiling).
    Item text always carries archetype signal (genres). Default False
    preserves the byte-exact rng stream of earlier corpora.
    """
    rng = np.random.default_rng(seed)
    out_dir = pathlib.Path(dest_dir, "ml-1m")
    out_dir.mkdir(parents=True, exist_ok=True)

    # latent structure
    movie_arch = rng.integers(0, num_archetypes, size=num_movies)
    user_arch = rng.integers(0, num_archetypes, size=num_users)
    # each archetype prefers 3 genres
    arch_genres = [
        rng.choice(len(GENRES), size=3, replace=False)
        for _ in range(num_archetypes)
    ]

    # movies.dat: movie_id::title (year)::genre|genre
    movie_lines = []
    for movie_id in range(1, num_movies + 1):
        arch = movie_arch[movie_id - 1]
        name = (
            f"{_ADJECTIVES[rng.integers(len(_ADJECTIVES))]} "
            f"{_NOUNS[rng.integers(len(_NOUNS))]} {movie_id}"
        )
        year = 1970 + int(rng.integers(0, 31))
        genre_ids = list(arch_genres[arch][: 1 + int(rng.integers(0, 3))])
        genres = "|".join(GENRES[g] for g in genre_ids)
        movie_lines.append(f"{movie_id}::{name} ({year})::{genres}")
    (out_dir / "movies.dat").write_text(
        "\n".join(movie_lines) + "\n", encoding="iso-8859-1"
    )

    # users.dat: user_id::gender::age::occupation::zipcode
    user_lines = []
    for user_id in range(1, num_users + 1):
        if text_signal:
            # attributes concentrate around the archetype so the
            # profile text predicts preferences: occupation lands in
            # the archetype's band 80% of the time, age/gender lean
            # the same way (softer: 70/60%)
            arch = int(user_arch[user_id - 1])
            band = _OCCUPATION_COUNT // num_archetypes or 1
            if rng.random() < 0.8:
                occupation = (
                    arch * band + int(rng.integers(0, band))
                ) % _OCCUPATION_COUNT
            else:
                occupation = int(rng.integers(0, _OCCUPATION_COUNT))
            if rng.random() < 0.7:
                age = _AGES[arch % len(_AGES)]
            else:
                age = _AGES[int(rng.integers(len(_AGES)))]
            if rng.random() < 0.6:
                gender = "MF"[arch % 2]
            else:
                gender = "MF"[int(rng.integers(0, 2))]
        else:
            gender = "MF"[int(rng.integers(0, 2))]
            age = _AGES[int(rng.integers(len(_AGES)))]
            occupation = int(rng.integers(0, _OCCUPATION_COUNT))
        zipcode = f"{int(rng.integers(10000, 99999)):05d}"
        user_lines.append(f"{user_id}::{gender}::{age}::{occupation}::{zipcode}")
    (out_dir / "users.dat").write_text(
        "\n".join(user_lines) + "\n", encoding="iso-8859-1"
    )

    # ratings.dat: user_id::movie_id::rating::timestamp
    # archetype-matched movies get higher ratings and higher pick probability
    # vary activity per user (power-law-ish) so holdout counts are not
    # tied — the val/test user split ranks users by holdout count
    mean_per_user = max(4, num_ratings // num_users)
    lines = []
    seen: set[tuple[int, int]] = set()
    # per-archetype movie id lists, precomputed ONCE — a flatnonzero
    # scan inside the user loop is O(users * movies) and blocks
    # multi-million-item corpora (10M movies x 200k users = 2e12 scans)
    arch_match = [
        np.flatnonzero(movie_arch == a) + 1 for a in range(num_archetypes)
    ]
    arch_other = [
        np.flatnonzero(movie_arch != a) + 1 for a in range(num_archetypes)
    ]
    for user_id in range(1, num_users + 1):
        per_user = 4 + int(rng.pareto(2.0) * mean_per_user)
        per_user = min(per_user, 4 * mean_per_user, num_movies // 2)
        arch = user_arch[user_id - 1]
        match = arch_match[arch]
        other = arch_other[arch]
        t = _BASE_TIMESTAMP + int(rng.integers(0, 10_000_000))
        for _ in range(per_user):
            if rng.random() < 0.7 and len(match) > 0:
                movie_id = int(match[rng.integers(len(match))])
                rating = int(rng.integers(3, 6))
            else:
                movie_id = int(other[rng.integers(len(other))])
                rating = int(rng.integers(1, 4))
            if (user_id, movie_id) in seen:
                continue
            seen.add((user_id, movie_id))
            t += int(rng.integers(60, 200_000))
            lines.append(f"{user_id}::{movie_id}::{rating}::{t}")
    (out_dir / "ratings.dat").write_text(
        "\n".join(lines) + "\n", encoding="iso-8859-1"
    )
    return out_dir


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_dir", default="data")
    parser.add_argument("--num_users", type=int, default=6040)
    parser.add_argument("--num_movies", type=int, default=3883)
    parser.add_argument("--num_ratings", type=int, default=1_000_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--text_signal", action="store_true")
    args = parser.parse_args()
    out = generate_movielens(
        args.data_dir,
        num_users=args.num_users,
        num_movies=args.num_movies,
        num_ratings=args.num_ratings,
        seed=args.seed,
        text_signal=args.text_signal,
    )
    print(f"synthetic corpus written to {out}")


if __name__ == "__main__":
    main()
