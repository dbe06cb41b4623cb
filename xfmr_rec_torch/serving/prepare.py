"""Serve CLI: train or load an artifact, check every endpoint, serve it.

Port of `xfmr_rec_tpu/serving/prepare.py`. When `--artifact_dir` holds no
artifact, one is trained by the port's `Trainer` (one train and one
validation batch) on the data the port's data layer prepares offline: the
raw ML-1M files under `data/ml-1m/` if present, else a synthetic corpus;
nothing is downloaded. The service is then built in-process and the
golden checks of `test_queries` run over its endpoints before it serves.
The arguments are parsed by `main` itself, so the installed
`xfmr-rec-torch-serve` command reads them.

    xfmr-rec-torch-serve --artifact_dir artifacts/run --serve \\
        [--allow-catalog-mutation] [--port 8000]
    python -m xfmr_rec_torch.serving.prepare --artifact_dir art --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import pathlib

from xfmr_rec_torch.data.module import DataConfig, RecDataModule
from xfmr_rec_torch.params import PROCESSORS_JSON
from xfmr_rec_torch.serving.engine import RecommenderEngine
from xfmr_rec_torch.serving.schemas import Query
from xfmr_rec_torch.serving.service import RecService, dispatch, serve_forever
from xfmr_rec_torch.training.module import TrainConfig
from xfmr_rec_torch.training.trainer import Trainer, TrainerConfig

logger = logging.getLogger(__name__)

# index kinds of the reference that the port does not serve yet
_NOT_PORTED_KINDS = {
    "ivf": "ROADMAP.md, Queue 1 item 10",
    "sharded": "ROADMAP.md, Queue 1 item 11",
}


def prepare_artifact(
    artifact_dir: str | pathlib.Path, *, device: str = "cuda"
) -> pathlib.Path:
    """Train the default config on one train and one validation batch
    and write the serving artifact."""
    trainer = Trainer(
        TrainConfig(),
        data=RecDataModule(DataConfig()),
        trainer_config=TrainerConfig(
            limit_train_batches=1, limit_val_batches=1
        ),
        device=device,
    )
    trainer.fit()
    trainer.save(artifact_dir)
    return pathlib.Path(artifact_dir)


def test_queries(service: RecService) -> None:
    """Golden-value checks over the endpoint surface; raises on a miss."""

    def check(cond: bool, what: str) -> None:
        if not cond:
            raise AssertionError(what)

    check(isinstance(dispatch(service, "model_name", {}), str), "model_name")
    check(isinstance(dispatch(service, "model_version", {}), str),
          "model_version")

    # item and user lookups round-trip through their own stores
    item = service.item_id(1)
    check(item.movie_id == 1 and bool(item.movie_text), "item_id")
    check(service.process_item(item).text == item.movie_text, "process_item")
    user = service.user_id(1)
    check(user.user_id == 1 and bool(user.user_text), "user_id")
    check(service.process_user(user).text == user.user_text, "process_user")

    query = service.embed_query(Query(text=item.movie_text))
    check(bool(query.embedding), "embed_query")

    # every recommend endpoint returns parseable candidates
    for endpoint, payload in [
        ("recommend_with_query", {"query": {"text": user.user_text}}),
        ("recommend_with_item", {"item": dataclasses.asdict(item)}),
        ("recommend_with_item_id", {"item_id": 1}),
        ("recommend_with_user", {"user": dataclasses.asdict(user)}),
        ("recommend_with_user_id", {"user_id": 1}),
    ]:
        result = dispatch(service, endpoint, {**payload, "top_k": 5})
        check(isinstance(result, list) and len(result) == 5, endpoint)
        for candidate in result:
            check({"movie_id", "movie_text", "score"} <= set(candidate),
                  endpoint)

    # self and history exclusion
    recs = service.recommend_with_item_id(1, top_k=5)
    check(all(c.movie_id != 1 for c in recs), "item excluded from its recs")
    seen = {a.movie_id for a in (user.history or []) + (user.target or [])}
    recs = service.recommend_with_user_id(1, top_k=5)
    check(not {c.movie_id for c in recs} & seen, "user history excluded")

    # keyword search: positive scores, best first, the fields of the row
    for endpoint, text, fields in [
        ("search_items_text", item.movie_text, {"movie_id", "movie_text"}),
        ("search_users_text", user.user_text, {"user_id", "user_text"}),
    ]:
        hits = dispatch(service, endpoint, {"query": text, "top_k": 5})
        scores = [hit["score"] for hit in hits]
        check(bool(hits) and all(s > 0 for s in scores)
              and scores == sorted(scores, reverse=True)
              and all(fields <= set(hit) for hit in hits), endpoint)
    if not service.allow_catalog_mutation:
        try:
            dispatch(service, "add_items", {"items": []})
            refused = False
        except PermissionError:
            refused = True
        check(refused, "add_items answered without allow_catalog_mutation")
    logger.info("serving golden-value checks passed")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="xfmr-rec-torch-serve",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--artifact_dir", default="artifact")
    parser.add_argument("--serve", action="store_true",
                        help="serve over HTTP after the checks pass")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument(
        "--index_kind", default="exact",
        help="item search path: only 'exact' (one card) is ported; "
        + ", ".join(f"{k!r} ({v})" for k, v in _NOT_PORTED_KINDS.items()),
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument(
        "--allow-catalog-mutation", action="store_true",
        help="expose the add_items endpoint (off by default: any client of "
        "the port could otherwise grow the catalog)",
    )
    args = parser.parse_args(argv)
    if args.index_kind != "exact":
        where = _NOT_PORTED_KINDS.get(args.index_kind)
        parser.error(
            f"--index_kind {args.index_kind!r} is not ported yet ({where})"
            if where
            else f"unknown --index_kind {args.index_kind!r}"
        )
    return args


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    path = pathlib.Path(args.artifact_dir)
    if not (path / PROCESSORS_JSON).exists():
        prepare_artifact(path, device=args.device)
    engine = RecommenderEngine(path, device=args.device)
    service = RecService(
        engine, allow_catalog_mutation=args.allow_catalog_mutation
    )
    try:
        test_queries(service)
        if args.serve:
            serve_forever(service, port=args.port)
    finally:
        service.close()


if __name__ == "__main__":
    main()
