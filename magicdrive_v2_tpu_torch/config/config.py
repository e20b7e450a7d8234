"""Config system of the port (its own copy of the JAX package's config/config.py):
python experiment files whose module-level names become config keys, with
``_base_`` inheritance, ``--cfg-options a.b.c=value`` overrides, and the dataset
YAMLs with their ``defaults:`` and ``${...key}`` interpolation (``yaml_compose.py``).

The experiment files under ``configs/`` import their presets from the JAX
package. ``Config.fromfile`` points those imports at this package's
``config/presets.py`` before it runs a file, so loading a config imports nothing
of the JAX package.
"""
from __future__ import annotations

import argparse
import ast
import os
import re
from typing import Any, Dict, List, Optional, Sequence

_PORT_PKG = __name__.split(".")[0]
_JAX_PKG = _PORT_PKG[:-len("_torch")]
_JAX_IMPORT = re.compile(rf"\b{re.escape(_JAX_PKG)}(?=\.)")


class Config(dict):
    """A dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for src in list(args) + [kwargs]:
            for k, v in dict(src).items():
                self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def set_path(self, dotted: str, value):
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if isinstance(node, (list, tuple)) and part.lstrip("-").isdigit():
                node = node[int(part)]
                continue
            if part not in node or not isinstance(node[part], (dict, list)):
                node[part] = Config()
            node = node[part]
        last = parts[-1]
        if isinstance(node, list) and last.lstrip("-").isdigit():
            node[int(last)] = Config._wrap(value)
        else:
            node[last] = Config._wrap(value)

    def merge(self, other: Dict):
        """Deep-merge: nested dicts merge key-wise, everything else replaces."""
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, dict):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        """Load a python or yaml config. A python file's ``_base_`` file(s) load
        first and the child's values deep-merge over them (nested dicts merge
        key-wise; everything else replaces)."""
        path = os.path.abspath(path)
        if path.endswith((".yaml", ".yml")):
            from .yaml_compose import load_yaml_config
            return cls(load_yaml_config(path))
        if not path.endswith(".py"):
            raise ValueError(f"{path!r}: a config is a .py or .yaml file")
        with open(path) as f:
            src = _JAX_IMPORT.sub(_PORT_PKG, f.read())
        ns: Dict[str, Any] = {"__file__": path, "__name__": "<config>"}
        exec(compile(src, path, "exec"), ns)
        cfg = cls()
        bases = ns.get("_base_")
        if bases:
            for b in [bases] if isinstance(bases, str) else bases:
                cfg.merge(cls.fromfile(os.path.join(os.path.dirname(path), b)))
        child = cls()
        for k, v in ns.items():
            if k.startswith("_") or callable(v) or isinstance(v, type(os)):
                continue
            child[k] = v
        cfg.merge(child)
        cfg["config_path"] = path
        return cfg


def literal(value: str):
    """Parse a CLI override value: python literal if possible, else raw string."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def merge_dot_options(cfg: Config, options: Sequence[str]) -> Config:
    """Apply ``a.b.c=value`` overrides."""
    for opt in options or []:
        if "=" not in opt:
            raise ValueError(f"Bad --cfg-options entry {opt!r}: expected key=value")
        key, _, raw = opt.partition("=")
        cfg.set_path(key.strip(), literal(raw.strip()))
    return cfg


def parse_configs(argv: Optional[List[str]] = None) -> Config:
    """CLI entry: positional config path + common flags + dot overrides."""
    parser = argparse.ArgumentParser()
    parser.add_argument("config", help="experiment config file (.py)")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--ckpt-path", "--ckpt_path", dest="ckpt_path", default=None)
    parser.add_argument("--outputs", default=None)
    parser.add_argument("--data-path", dest="data_path", default=None)
    parser.add_argument("--resume", default=None)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--cfg-options", nargs="+", default=[])
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config)
    for key in ("seed", "ckpt_path", "outputs", "data_path", "resume"):
        val = getattr(args, key)
        if val is not None:
            cfg[key] = val
    if args.debug:
        cfg["debug"] = True
    merge_dot_options(cfg, args.cfg_options)
    return cfg


def merge_dataset_cfg(cfg: Config, data_cfg_name: str, overrides: Sequence = (),
                      num_frames=None, img_size=None, search_dirs: Sequence[str] = ()):
    """Compose a dataset yaml into cfg.dataset with ``(key, value)`` override tuples
    (a leading ``+`` on a key is dropped). The yaml is ``data_cfg_name`` itself, or
    ``NAME.yaml`` under ``search_dirs``, ``configs/dataset`` or the repository's
    ``configs/dataset``."""
    from .yaml_compose import load_yaml_config

    candidates = [data_cfg_name]
    repo_dataset = os.path.join(os.path.dirname(__file__), "../../configs/dataset")
    for d in list(search_dirs) + ["configs/dataset", repo_dataset]:
        candidates.append(os.path.join(d, data_cfg_name + ".yaml"))
        candidates.append(os.path.join(d, data_cfg_name))
    path = next((c for c in candidates if os.path.isfile(c)), None)
    if path is None:
        raise FileNotFoundError(f"dataset config {data_cfg_name!r} not found in {search_dirs}")

    root = Config({"dataset": Config(load_yaml_config(path))})
    for key, value in overrides or ():
        root.set_path(key.lstrip("+"), value)
    if num_frames is not None:
        root.set_path("dataset.num_frames", num_frames)
    if img_size is not None:
        root.set_path("dataset.image_size", list(img_size))
    cfg["dataset"] = root["dataset"]
    return cfg
