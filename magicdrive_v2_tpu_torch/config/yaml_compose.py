"""YAML loading with OmegaConf-style interpolation (the port's own copy of the JAX
package's config/yaml_compose.py).

Dataset configs are composed the hydra/OmegaConf way; the subset their yamls use:

- relative interpolation ``${...image_size}``: N leading dots = climb N-1 levels from the
  *containing node*, then follow the (dot/index) path;
- absolute interpolation ``${a.b.c}`` from the document root;
- indexing into lists with ``.N`` or ``[N]`` (e.g. ``${...augment2d.resize[0]}``).
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple

import yaml

_INTERP = re.compile(r"^\$\{([^}]*)\}$")


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml_config(path: str) -> dict:
    """Load + compose. Supports the hydra `defaults:` subset the reference's dataset
    yamls use: a list of `/dataset/NAME` parents merged in order under the current
    doc (reference configs/dataset/*.yaml headers)."""
    import os

    with open(path) as f:
        doc = yaml.safe_load(f)
    defaults = doc.pop("defaults", None) if isinstance(doc, dict) else None
    if defaults:
        base: dict = {}
        cfg_dir = os.path.dirname(os.path.abspath(path))
        for item in defaults:
            if isinstance(item, str):
                name = item.split("/")[-1]
                parent = os.path.join(cfg_dir, name + ".yaml")
                base = _deep_merge(base, load_yaml_config_raw(parent))
        doc = _deep_merge(base, doc)
    return resolve_interpolations(doc)


def load_yaml_config_raw(path: str) -> dict:
    """Compose defaults without resolving interpolations (parents may reference
    keys the child overrides)."""
    import os

    with open(path) as f:
        doc = yaml.safe_load(f)
    defaults = doc.pop("defaults", None) if isinstance(doc, dict) else None
    if defaults:
        base: dict = {}
        cfg_dir = os.path.dirname(os.path.abspath(path))
        for item in defaults:
            if isinstance(item, str):
                name = item.split("/")[-1]
                base = _deep_merge(base,
                                   load_yaml_config_raw(os.path.join(cfg_dir,
                                                                     name + ".yaml")))
        doc = _deep_merge(base, doc)
    return doc


def _parse_ref(ref: str) -> Tuple[int, List[Any]]:
    """Return (n_leading_dots, path_parts)."""
    ups = 0
    while ups < len(ref) and ref[ups] == ".":
        ups += 1
    body = ref[ups:]
    parts: List[Any] = []
    for tok in re.split(r"\.", body):
        if not tok:
            continue
        m = re.match(r"([^\[\]]*)((\[\d+\])*)$", tok)
        name, idxs = m.group(1), m.group(2)
        if name:
            parts.append(name)
        for i in re.findall(r"\[(\d+)\]", idxs or ""):
            parts.append(int(i))
    return ups, parts


def _lookup(root: Any, node_path: List[Any], ref: str) -> Tuple[Any, List[Any]]:
    """Resolve `ref` relative to the node at `node_path`; return (value, value_path)."""
    ups, parts = _parse_ref(ref)
    if ups == 0:
        base_path: List[Any] = []
    else:
        # OmegaConf: "${.x}" = containing node; each extra dot climbs one level.
        base_path = node_path[: max(0, len(node_path) - (ups - 1))]
    path = base_path + parts
    node = root
    norm_path = []
    for p in path:
        if isinstance(node, list) and isinstance(p, str) and p.lstrip("-").isdigit():
            p = int(p)  # dotted list index, e.g. ${...dataset_cache_file.0}
        node = node[p]
        norm_path.append(p)
    return node, norm_path


_INTERP_PART = re.compile(r"\$\{([^}]*)\}")


def resolve_interpolations(doc: Any) -> Any:
    def resolve(node: Any, path: List[Any]) -> Any:
        if isinstance(node, dict):
            return {k: resolve(v, path + [k]) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v, path + [i]) for i, v in enumerate(node)]
        if isinstance(node, str):
            m = _INTERP.match(node)
            if m:  # whole-string interpolation: keep the referenced type
                target, target_path = _lookup(doc, path[:-1], m.group(1))
                return resolve(target, target_path)
            if _INTERP_PART.search(node):  # embedded: string substitution
                def sub(match):
                    target, target_path = _lookup(doc, path[:-1], match.group(1))
                    return str(resolve(target, target_path))
                return _INTERP_PART.sub(sub, node)
        return node

    return resolve(doc, [])
