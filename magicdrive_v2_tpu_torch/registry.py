"""Name registry of the port: experiment configs name components by ``type=``
(``vae``, ``text_encoder``) and ``MagicDrivePipeline.from_config`` looks them up
here. The registering modules add themselves when they are imported."""
from __future__ import annotations

from typing import Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, Callable] = {}

    def register_module(self, name: Optional[str] = None):
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
