"""PyTorch port, the config system (``config/config.py``, ``config/presets.py``)
against the JAX package's: every inference, train and test config loads in a
process that imports nothing of JAX and gives the dict the JAX loader gives;
overrides and ``_base_`` inheritance behave alike."""
import glob
import json
import os
import subprocess
import sys

import pytest

from magicdrive_v2_tpu.config import config as J
from magicdrive_v2_tpu.config import presets as JP
from magicdrive_v2_tpu_torch.config import config as T
from magicdrive_v2_tpu_torch.config import presets as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INFERENCE = sorted(glob.glob(os.path.join(REPO, "configs/magicdrive/inference/*.py")))
TRAIN_TEST = sorted(glob.glob(os.path.join(REPO, "configs/magicdrive/train/*.py"))
                    + glob.glob(os.path.join(REPO, "configs/magicdrive/test/*.py")))

_NO_JAX_LOAD = r"""
import glob, json, sys
from magicdrive_v2_tpu_torch.config.config import Config
out = {}
for path in sorted(glob.glob("configs/magicdrive/inference/*.py")
                   + glob.glob("configs/magicdrive/train/*.py")
                   + glob.glob("configs/magicdrive/test/*.py")):
    cfg = Config.fromfile(path)
    out[path] = sorted(cfg)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "magicdrive_v2_tpu"))
assert not bad, bad
print(json.dumps(out))
"""


def _plain(v):
    """Config -> nested builtins (dict/list/tuple), for an equality across the two
    packages' Config classes."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


def test_inference_configs_load_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_LOAD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(loaded) == len(INFERENCE) + len(TRAIN_TEST)
    assert len(INFERENCE) >= 9 and len(TRAIN_TEST) >= 10
    for keys in loaded.values():
        assert {"model", "scheduler", "config_path"} <= set(keys)


@pytest.mark.parametrize("path", INFERENCE, ids=os.path.basename)
def test_inference_config_equals_the_jax_loader(path):
    ours, theirs = _plain(T.Config.fromfile(path)), _plain(J.Config.fromfile(path))
    assert ours.pop("config_path") == theirs.pop("config_path") == path
    assert ours == theirs


@pytest.mark.parametrize("path", TRAIN_TEST, ids=lambda p: os.path.relpath(
    p, os.path.join(REPO, "configs/magicdrive")))
def test_train_and_test_config_equals_the_jax_loader(path):
    ours, theirs = _plain(T.Config.fromfile(path)), _plain(J.Config.fromfile(path))
    assert ours.pop("config_path") == theirs.pop("config_path") == path
    assert ours == theirs


def test_base_inheritance_and_dot_overrides(tmp_path):
    (tmp_path / "base.py").write_text(
        "a = 1\nmodel = dict(depth=28, heads=16, sub=dict(x=1, y=2))\nlst = [1, 2, 3]\n")
    (tmp_path / "child.py").write_text(
        "_base_ = './base.py'\nb = 'two'\nmodel = dict(depth=2, sub=dict(y=5))\n"
        "def helper():\n    return 1\n")
    child = str(tmp_path / "child.py")
    opts = ["model.sub.z=[4, 5]", "lst.1=9", "name=some/path", "a=None", "model.heads=(1, 2)"]
    ours = T.merge_dot_options(T.Config.fromfile(child), opts)
    theirs = J.merge_dot_options(J.Config.fromfile(child), opts)
    assert _plain(ours) == _plain(theirs)
    assert ours.model.depth == 2 and ours.model.sub == {"x": 1, "y": 5, "z": [4, 5]}
    assert ours.lst == [1, 9, 3] and ours.name == "some/path" and ours.a is None
    assert "helper" not in ours
    with pytest.raises(ValueError, match="key=value"):
        T.merge_dot_options(ours, ["no_equals_sign"])
    args = [child, "--seed", "7", "--cfg-options", "b=3"]
    assert _plain(T.parse_configs(args)) == _plain(J.parse_configs(args))
    # a base config of the repository, through its relative _base_
    smoke = os.path.join(REPO, "configs/magicdrive/test/smoke_tiny.py")
    ours, theirs = _plain(T.Config.fromfile(smoke)), _plain(J.Config.fromfile(smoke))
    assert ours == theirs and ours["model"]["depth"] == 2


def test_presets_equal_the_jax_presets():
    for name in ("xl2_model", "cogvae", "t5_xxl", "rflow", "default_mask_ratios",
                 "img_collate_param"):
        assert getattr(TP, name)() == getattr(JP, name)(), name
    assert TP.img_collate_param("all-xyz", False) == JP.img_collate_param("all-xyz", False)
    assert TP.xl2_model(sp_size=4, bbox_mode="cxyz") == JP.xl2_model(sp_size=4, bbox_mode="cxyz")
    assert (TP.MV_ORDER_MAP, TP.NUSCENES_CLASSES) == (JP.MV_ORDER_MAP, JP.NUSCENES_CLASSES)
