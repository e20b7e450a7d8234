"""Name registry of the port: experiment configs name components by ``type=``
(``vae``, ``text_encoder``, a dataset split) and ``MagicDrivePipeline.from_config``
and the apps' ``build_module`` look them up here. The registering modules add
themselves when they are imported."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, Callable] = {}

    def register_module(self, name: Optional[str] = None,
                        module: Optional[Callable] = None):
        if module is not None:
            self._modules[name or module.__name__] = module
            return module

        def _register(cls):
            self._modules[name or cls.__name__] = cls
            return cls
        return _register

    def get(self, name: str) -> Callable:
        if name in self._modules:
            return self._modules[name]
        raise KeyError(f"{name!r} is not registered in registry {self.name!r}. "
                       f"Known: {sorted(self._modules)}")


MODELS = Registry("models")
DATASETS = Registry("datasets")


def build_module(cfg: Any, registry: Registry, **extra):
    """Instantiate the registered ``cfg["type"]`` with the remaining keys as keyword
    arguments; a value that is not a dict passes through unchanged."""
    if cfg is None or not isinstance(cfg, dict):
        return cfg
    if registry is DATASETS:
        from . import datasets  # noqa: F401  (registers the dataset classes)
    cfg = dict(cfg)
    kind = cfg.pop("type")
    return registry.get(kind)(**cfg, **extra)
