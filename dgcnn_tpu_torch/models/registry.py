"""Model registry: MODEL_NAME -> constructor (port of
`dgcnn_tpu/models/registry.py`)."""

from __future__ import annotations

import dataclasses

from dgcnn_tpu_torch.models.dgcnn import Model, ModelSpec, make_model

_REGISTRY = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


@register_model("dgcnn")
def _plain(spec: ModelSpec, **kw) -> Model:
    return make_model(dataclasses.replace(spec, residual=False), **kw)


@register_model("residual-dgcnn")
def _residual(spec: ModelSpec, **kw) -> Model:
    return make_model(dataclasses.replace(spec, residual=True), **kw)


def model_names():
    return sorted(_REGISTRY)


def get_model(name: str, spec: ModelSpec, **kw) -> Model:
    """Build a model by reference-style MODEL_NAME."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {model_names()}")
    return _REGISTRY[name](spec, **kw)
