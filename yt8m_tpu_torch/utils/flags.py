"""Dataclass -> CLI flags with the reference's names (a copy of the JAX
package's helper, so that the port imports nothing of that package).

Supports --flag=value and --flag value; booleans accept true/false/1/0 or
bare `--flag` for True (tf.app.flags style).
"""

from __future__ import annotations

import argparse
import dataclasses
import typing

# Optional/int/str et al. must be importable here: dataclass annotations
# are strings (PEP 563) and get eval'd in this module's namespace.
from typing import Optional  # noqa: F401


def _parse_bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "t", "1", "yes"):
        return True
    if v.lower() in ("false", "f", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"bad boolean {v!r}")


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def add_dataclass_flags(parser: argparse.ArgumentParser, cls) -> None:
    for field in dataclasses.fields(cls):
        if dataclasses.is_dataclass(field.type) or dataclasses.is_dataclass(
            getattr(field, "default_factory", None)
        ):
            continue  # nested hparams handled separately
        tp = _unwrap_optional(
            field.type if not isinstance(field.type, str) else eval(field.type)
        )
        if dataclasses.is_dataclass(tp):
            continue
        name = f"--{field.name}"
        if name in parser._option_string_actions:
            continue  # config dataclass wins over duplicate hparam names
        default = (
            field.default
            if field.default is not dataclasses.MISSING
            else None
        )
        if tp is bool:
            parser.add_argument(
                name, type=_parse_bool, nargs="?", const=True,
                default=default,
            )
        elif tp in (int, float, str):
            parser.add_argument(name, type=tp, default=default)


def parse_into(cls, argv=None, hparams_cls=None):
    """Parse argv into `cls` (+ nested `hparams` if hparams_cls given)."""
    parser = argparse.ArgumentParser(allow_abbrev=False)
    add_dataclass_flags(parser, cls)
    if hparams_cls is not None:
        add_dataclass_flags(parser, hparams_cls)
    ns, unknown = parser.parse_known_args(argv)
    if unknown:
        raise SystemExit(f"unknown flags: {unknown}")
    ns_dict = vars(ns)
    cfg_kw = {
        f.name: ns_dict[f.name]
        for f in dataclasses.fields(cls)
        if f.name in ns_dict and ns_dict[f.name] is not None
    }
    cfg = cls(**cfg_kw)
    if hparams_cls is not None:
        hp_kw = {
            f.name: ns_dict[f.name]
            for f in dataclasses.fields(hparams_cls)
            if f.name in ns_dict and ns_dict[f.name] is not None
        }
        cfg.hparams = hparams_cls(**hp_kw)
    return cfg, ns


def _explicit_flag_names(argv) -> set:
    """Flag names the user actually typed (vs parser defaults)."""
    import sys

    if argv is None:  # argparse's own default source
        argv = sys.argv[1:]
    names = set()
    for tok in argv or []:
        if tok.startswith("--"):
            names.add(tok[2:].split("=", 1)[0])
    return names


# model_flags.json keys describing the model/reader STRUCTURE; the
# trainer records them (train/loop.py::_write_model_flags) and
# eval/inference rebuild the graph from them (reference eval.py /
# inference.py read the same file so a run is self-describing).
_RECORDED_CONFIG_KEYS = (
    "model",
    "frame_features",
    "feature_names",
    "feature_sizes",
    "num_classes",
    "max_frames",
    "label_loss",
)


def apply_recorded_model_flags(cfg, argv) -> bool:
    """Rebuild-from-flags (reference eval.py/inference.py behavior):
    when `cfg.train_dir/model_flags.json` exists, structural model and
    reader fields are taken from the recording so eval/inference work
    without re-typing the training flags. Explicitly-passed CLI flags
    win over recorded values; runtime/serving knobs
    (RUNTIME_HPARAM_FIELDS) always stay under CLI control.

    Returns True when a recording was found and applied.
    """
    import json
    import logging
    import os

    from yt8m_tpu_torch.models.hparams import RUNTIME_HPARAM_FIELDS

    path = os.path.join(cfg.train_dir, "model_flags.json")
    if not os.path.exists(path):
        return False
    with open(path) as f:
        data = json.load(f)
    explicit = _explicit_flag_names(argv)
    applied = []
    for key in _RECORDED_CONFIG_KEYS:
        if key in data and key not in explicit and hasattr(cfg, key):
            if getattr(cfg, key) != data[key]:
                applied.append(f"{key}={data[key]!r}")
            setattr(cfg, key, data[key])
    hp_over = {
        k: v
        for k, v in data.get("hparams", {}).items()
        if k not in RUNTIME_HPARAM_FIELDS
        and k not in explicit
        and hasattr(cfg.hparams, k)
    }
    if hp_over:
        cfg.hparams = cfg.hparams.replace(**hp_over)
    logging.getLogger("yt8m_tpu_torch.flags").info(
        "rebuilt run config from %s%s", path,
        (" (" + ", ".join(applied) + ")") if applied else "",
    )
    return True
