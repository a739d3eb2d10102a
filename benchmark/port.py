"""The benchmark's only door into the program under test.

Every call the drivers make into ``inraudio_tpu_torch`` goes through this
module, so that a test can put a broken or a plain program in its place.
A driver names the port's public entry it calls as its ``door``: a dotted
path inside the package (``train.modulated.modulated_fit``), or one of the
short names ``fit``, ``multi_inr_fit`` and ``decode_dense``.  ``door(name)``
resolves the name on first use and keeps the entry in ``DOORS``; a driver
calls ``door(self.door)(...)`` at every call, so an entry planted in
``DOORS`` is what the timed path runs.  The program is built from a
configuration file's keys with the port's own config classes (``config``)
and model builder (``build_model``).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch

from inraudio_tpu_torch import models
from inraudio_tpu_torch.train.loop import init_train_state

__all__ = ["DOORS", "build_model", "config", "door", "given_init",
           "initial_state", "multi_config", "train_config"]

PACKAGE = "inraudio_tpu_torch"
_SHORT = {"fit": "train.loop.fit",
          "multi_inr_fit": "train.multi_inr.multi_inr_fit",
          "decode_dense": "eval.decode.decode_dense"}
# the builder's own keywords that a configuration file may set
_BUILDER_KEYS = ("fused", "approx_sin")

DOORS: dict[str, Callable] = {}


def _public(path: str) -> Callable:
    """The public callable ``path`` (dotted, inside the package) of the
    port, imported on first use.  Raises ``ValueError`` for a name outside
    the package or not its own, a private name, or one that names nothing
    callable."""
    parts = path.split(".")
    if len(parts) < 2 or not all(p.isidentifier() for p in parts):
        raise ValueError(f"{path!r} is not a dotted name inside {PACKAGE}")
    if any(p.startswith("_") for p in parts):
        raise ValueError(f"{path!r} is private: a door is a public entry")
    module = f"{PACKAGE}.{'.'.join(parts[:-1])}"
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name is None or not module.startswith(e.name):
            raise
        raise ValueError(f"{PACKAGE} has no module {module!r}") from e
    if not hasattr(mod, parts[-1]):
        raise ValueError(f"{module} has no {parts[-1]!r}")
    obj = getattr(mod, parts[-1])
    if not callable(obj):
        raise ValueError(f"{path!r} is not callable")
    if (getattr(obj, "__module__", None) or "").split(".")[0] != PACKAGE:
        raise ValueError(f"{path!r} is not defined in {PACKAGE}")
    return obj


def door(name: str) -> Callable:
    """The port's entry that a driver names as its door (kept in
    ``DOORS``)."""
    if name not in DOORS:
        DOORS[name] = _public(_SHORT.get(name, name))
    return DOORS[name]


def _from_keys(cls, cfg: dict):
    """``cls`` with the fields that the configuration has (a list becomes
    a tuple), the rest left at their defaults."""
    if not dataclasses.is_dataclass(cls):
        raise ValueError(f"{cls.__name__} is not a config class")
    return cls(**{f.name: tuple(cfg[f.name]) if isinstance(cfg[f.name], list)
                  else cfg[f.name]
                  for f in dataclasses.fields(cls) if f.name in cfg})


def config(path: str, cfg: dict):
    """The port's config dataclass at ``path`` (``train.loop.TrainConfig``),
    its fields taken from the configuration's keys of the same names."""
    return _from_keys(_public(path), cfg)


def build_model(cfg: dict, **extra):
    """The port's model of a configuration, as the runner builds it: any
    arch of ``models.build_model``, with the config class that the port's
    builder gives the arch, ``fused`` and ``approx_sin`` from the
    configuration, and ``extra`` (an ``rff_b`` a driver draws) passed
    through."""
    arch = cfg["arch"]
    cls = type(models.build_model(arch).config)
    return models.build_model(arch, _from_keys(cls, cfg),
                              **{k: cfg[k] for k in _BUILDER_KEYS
                                 if k in cfg}, **extra)


def train_config(cfg: dict, steps: int):
    return config("train.loop.TrainConfig", {**cfg, "total_steps": int(steps)})


def multi_config(cfg: dict):
    return config("train.multi_inr.MultiINRConfig", cfg)


def given_init(model, params: dict):
    """The model with its initial parameters replaced by ``params``, made by
    the benchmark: the program's init returns them whatever its generator
    (a copy of each leaf, so that the program never writes the
    benchmark's)."""
    return dataclasses.replace(
        model, init=lambda generator, dev, windows=None: {
            "layers": [{k: v.clone() for k, v in layer.items()}
                       for layer in params["layers"]]})


def initial_state(model, params: dict, cfg: dict, device: torch.device):
    """The port's fresh TrainState around parameters the benchmark made."""
    given = dataclasses.replace(
        model, init=lambda generator, dev, windows=None: params)
    return init_train_state(given, torch.Generator(), train_config(cfg, 1),
                            device)
