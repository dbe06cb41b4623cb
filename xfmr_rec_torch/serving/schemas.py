"""Serving request/response schemas: dataclasses with the field names and
defaults of `xfmr_rec_tpu/serving/schemas.py`, so JSON bodies are
interchangeable between the two services."""

from __future__ import annotations

import dataclasses
from typing import Any


def _from_dict(cls, value: Any):
    """Build `cls` from a JSON object (or pass an instance through);
    unknown keys are ignored, as the reference's pydantic models do."""
    if isinstance(value, cls):
        return value
    if not isinstance(value, dict):
        msg = f"{cls.__name__} expects an object, got {type(value).__name__}"
        raise TypeError(msg)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in value.items() if k in names})


@dataclasses.dataclass
class Activity:
    datetime: int
    rating: int
    movie_rn: int
    movie_id: int
    movie_text: str

    @classmethod
    def from_dict(cls, value: Any) -> Activity:
        return _from_dict(cls, value)


@dataclasses.dataclass
class UserQuery:
    user_rn: int = 0
    user_id: int = 0
    user_text: str = ""
    history: list[Activity] | None = None
    target: list[Activity] | None = None

    @classmethod
    def from_dict(cls, value: Any) -> UserQuery:
        user = _from_dict(cls, value)
        for name in ("history", "target"):
            entries = getattr(user, name)
            if entries is not None:
                setattr(user, name, [Activity.from_dict(e) for e in entries])
        return user


@dataclasses.dataclass
class ItemQuery:
    movie_rn: int = 0
    movie_id: int = 0
    movie_text: str = ""

    @classmethod
    def from_dict(cls, value: Any) -> ItemQuery:
        return _from_dict(cls, value)


@dataclasses.dataclass
class Query:
    text: str = ""
    embedding: list[float] | None = None

    @classmethod
    def from_dict(cls, value: Any) -> Query:
        return _from_dict(cls, value)


@dataclasses.dataclass
class ItemCandidate:
    movie_id: int
    movie_text: str
    score: float


class NotFoundError(LookupError):
    """Raised for unknown ids; the HTTP layer maps it to 404."""
