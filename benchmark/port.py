"""The benchmark's only door into the program under test.

Every call the drivers make into ``inraudio_tpu_torch`` goes through this
module, so that a test can put a broken or a plain program in its place.
The program is built from a configuration file's knobs with the port's own
config classes and builder, and fitted and decoded through its public
entries (``train.loop.fit``, ``train.multi_inr.multi_inr_fit``,
``eval.decode.decode_dense``).  A driver names the entry it calls as its
``door``.
"""

from __future__ import annotations

import dataclasses

import torch

from inraudio_tpu_torch.eval.decode import decode_dense
from inraudio_tpu_torch.models import (KANConfig, SirenSnakeTanhConfig,
                                       build_model as _build)
from inraudio_tpu_torch.train.loop import TrainConfig, fit, init_train_state
from inraudio_tpu_torch.train.multi_inr import MultiINRConfig, multi_inr_fit

__all__ = ["build_model", "decode_dense", "fit", "given_init",
           "initial_state", "multi_config", "multi_inr_fit", "train_config"]

_MODEL_CONFIGS = {"mlp": SirenSnakeTanhConfig, "kan": KANConfig}


def _knobs(cls, cfg: dict) -> dict:
    out = {}
    for f in dataclasses.fields(cls):
        if f.name in cfg:
            v = cfg[f.name]
            out[f.name] = tuple(v) if isinstance(v, list) else v
    return out


def build_model(cfg: dict):
    """The port's model of a configuration, as the runner builds it (a fused
    mlp takes the polynomial sin, as ``build_arch`` gives it)."""
    arch = cfg["arch"]
    mcfg = _MODEL_CONFIGS[arch](**_knobs(_MODEL_CONFIGS[arch], cfg))
    if arch == "mlp":
        return _build("mlp", mcfg, fused=cfg["fused"],
                      approx_sin=cfg["approx_sin"])
    return _build(arch, mcfg, fused=cfg["fused"])


def train_config(cfg: dict, steps: int) -> TrainConfig:
    return TrainConfig(total_steps=int(steps), **_knobs(TrainConfig, cfg))


def multi_config(cfg: dict) -> MultiINRConfig:
    return MultiINRConfig(**_knobs(MultiINRConfig, cfg))


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
