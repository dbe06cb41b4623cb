"""Training CLI: fit / validate / test / predict with layered config.

Port of `xfmr_rec_tpu/training/cli.py`: subcommands, a config file,
dotted `--model.x / --data.y / --trainer.z` overrides coerced by each
field's declared type, and `--print_config`. The config file is JSON
(the reference's YAML loader reads JSON too, so one file drives both
CLIs) and `--print_config` prints JSON. `--device` picks the torch
device (default `cuda`). `predict` runs the full predict cohort
(`Trainer.predict`) into `--output` (default `<log dir>/predictions.npz`;
the reference writes `predictions.parquet`), or, with `--user_id`, prints
one user's top-k as a JSON list (`Trainer.recommend_users`, the user's
train history excluded).

Examples:
    python -m xfmr_rec_torch.training.cli fit --print_config
    python -m xfmr_rec_torch.training.cli fit --config run.json \\
        --model.train_loss InfomationNoiseContrastiveEstimationLoss \\
        --model.learning_rate 0.001 --data.batch_size 64 \\
        --trainer.max_epochs 2 --save_artifact artifacts/run
    python -m xfmr_rec_torch.training.cli test --ckpt runs/<run>/ckpt/best
    python -m xfmr_rec_torch.training.cli predict --ckpt runs/<run>/ckpt/best
    python -m xfmr_rec_torch.training.cli predict --ckpt ... --user_id 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import types
import typing
from typing import Any

import numpy as np

from xfmr_rec_torch.data.module import DataConfig, RecDataModule
from xfmr_rec_torch.training.module import TrainConfig
from xfmr_rec_torch.training.trainer import Trainer, TrainerConfig

logger = logging.getLogger(__name__)

SECTIONS = {"model": TrainConfig, "data": DataConfig, "trainer": TrainerConfig}


def default_config() -> dict[str, dict[str, Any]]:
    return {
        name: dataclasses.asdict(cls()) for name, cls in SECTIONS.items()
    }


def _coerce_to_type(raw: str, annotation: Any) -> Any:
    """Parse a CLI string against a declared annotation: unions (members
    in declared order; 'null' / 'none' give None), bool, int, float, str,
    JSON for anything else."""
    origin = typing.get_origin(annotation)
    if origin in (typing.Union, types.UnionType):
        args = typing.get_args(annotation)
        if type(None) in args and raw.lower() in ("null", "none"):
            return None
        for member in args:
            if member is type(None):
                continue
            try:
                return _coerce_to_type(raw, member)
            except (ValueError, TypeError):
                continue
        msg = f"cannot parse {raw!r} as {annotation}"
        raise ValueError(msg)
    if annotation is bool:
        if raw.lower() in ("1", "true", "yes"):
            return True
        if raw.lower() in ("0", "false", "no"):
            return False
        msg = f"cannot parse {raw!r} as bool"
        raise ValueError(msg)
    if annotation is int:
        return int(raw)  # strict: '0.5' falls through to float in unions
    if annotation is float:
        return float(raw)
    if annotation is str:
        return raw
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def parse_overrides(
    config: dict[str, dict[str, Any]], argv: list[str]
) -> dict[str, dict[str, Any]]:
    """Apply `--section.key value` / `--section.key=value` in place."""
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--") or "." not in arg:
            msg = f"unrecognized argument: {arg}"
            raise SystemExit(msg)
        key = arg[2:]
        if "=" in key:
            key, raw = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                msg = f"missing value for {arg}"
                raise SystemExit(msg)
            raw = argv[i + 1]
            i += 2
        section, _, field = key.partition(".")
        if section not in config or field not in config[section]:
            msg = (
                f"unknown option --{key}; valid sections: {tuple(SECTIONS)}; "
                "see --print_config"
            )
            raise SystemExit(msg)
        annotation = typing.get_type_hints(SECTIONS[section])[field]
        try:
            config[section][field] = _coerce_to_type(raw, annotation)
        except (ValueError, TypeError) as err:
            msg = f"invalid value for --{key}: {err}"
            raise SystemExit(msg) from err
    return config


def build_trainer(
    config: dict[str, dict[str, Any]], device: str = "cuda"
) -> Trainer:
    return Trainer(
        TrainConfig(**config["model"]),
        data=RecDataModule(DataConfig(**config["data"])),
        trainer_config=TrainerConfig(**config["trainer"]),
        device=device,
    )


def recommend_user(trainer: Trainer, user_id: int) -> list[dict[str, Any]]:
    """One dataset user's top-k, the user's train history excluded."""
    matches = np.flatnonzero(trainer.data.user_ids == user_id)
    if not len(matches):
        msg = f"unknown user_id {user_id}"
        raise SystemExit(msg)
    upos = int(matches[0])
    exclude = trainer.data.train_history_item_ids(upos)
    return trainer.recommend_users([upos], exclude_ids=[exclude])[0]


def run(
    argv: list[str] | None = None,
) -> tuple[Trainer | None, dict[str, float] | None]:
    """Parse `argv` and run the subcommand; returns the trainer (None for
    `--print_config`) and the subcommand's metrics."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="xfmr_rec_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "subcommand", choices=["fit", "validate", "test", "predict"]
    )
    parser.add_argument("--config", help="JSON config file")
    parser.add_argument(
        "--print_config",
        action="store_true",
        help="print the resolved config and exit",
    )
    parser.add_argument("--ckpt", help="checkpoint path/name to restore")
    parser.add_argument(
        "--save_artifact", help="(fit) write serving artifact here after fit"
    )
    parser.add_argument(
        "--user_id",
        type=int,
        help="(predict) print this one user's recommendations; omit to run "
        "the full predict cohort to .npz",
    )
    parser.add_argument(
        "--output",
        help="(predict) .npz path for the cohort's predictions "
        "(default <run log dir>/predictions.npz)",
    )
    parser.add_argument(
        "--device", default="cuda", help="torch device (default cuda)"
    )
    args, rest = parser.parse_known_args(argv)

    config = default_config()
    if args.config:
        with open(args.config) as f:
            loaded = json.load(f) or {}
        for section in SECTIONS:
            config[section].update(loaded.get(section, {}))
    parse_overrides(config, rest)

    if args.print_config:
        json.dump(config, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return None, None
    trainer = build_trainer(config, args.device)
    if args.ckpt:
        trainer.restore_checkpoint(args.ckpt)
    else:
        trainer.setup()
    if args.subcommand == "fit":
        metrics = trainer.fit()
        logger.info("final: %s", metrics)
        if args.save_artifact:
            trainer.save(args.save_artifact)
    elif args.subcommand == "validate":
        metrics = trainer.validate()
        logger.info("validate: %s", metrics)
    elif args.subcommand == "test":
        metrics = trainer.test()
        logger.info("test: %s", metrics)
    elif args.user_id is not None:
        print(json.dumps(recommend_user(trainer, args.user_id), indent=2))
        metrics = None
    else:
        output = args.output or str(
            trainer.logger.log_dir / "predictions.npz"
        )
        predictions = trainer.predict(output)
        logger.info(
            "predict: %d users -> %s", len(predictions["user_id"]), output
        )
        metrics = None
    return trainer, metrics


def main(argv: list[str] | None = None) -> dict[str, float] | None:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(message)s"
    )
    return run(argv)[1]


if __name__ == "__main__":
    main()
