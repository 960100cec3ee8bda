"""PyTorch port: its own YAML loader vs the JAX package's, and a proof that
no module of the port imports ``jax`` or the JAX package."""

import glob
import os
import subprocess
import sys

import pytest

from audio_visual_deepfake_detection_tpu.core import config as jcfg
from audio_visual_deepfake_detection_tpu_torch.core import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, "configs_test", "*.yaml"))
               + glob.glob(os.path.join(REPO, "configs_train", "*.yaml")))

_WALK = """
import importlib, pkgutil, sys
import audio_visual_deepfake_detection_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from audio_visual_deepfake_detection_tpu_torch.core.config import (
    arch_config_from, load_config, test_config_from)
cfg = load_config(sys.argv[1])
arch = arch_config_from(cfg)
test_config_from(cfg)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
       or m.split(".")[0] == "audio_visual_deepfake_detection_tpu"]
need = [pkg.__name__ + m for m in (".parallel", ".parallel.mesh", ".cli.train",
                                    ".cli.convert_checkpoint", ".frontends.video",
                                    ".models.backbones", ".models.necks")]
legacy = {".frontends.video": ("C3DVideoEncoder", "init_c3d"),
          ".models.backbones": ("ConvTransformerBackbone", "ConvBackbone"),
          ".models.blocks": ("ConvBlock",), ".models.necks": ("FPNIdentity",)}
need += [f"{pkg.__name__}{m}.{a}" for m, attrs in legacy.items() for a in attrs
         if not hasattr(sys.modules[pkg.__name__ + m], a)]
print("MISSING", [m for m in need if m not in names])
print("MODULES", len(names), "INPUT_DIM", arch.input_dim, "BAD", bad)
"""


def test_port_imports_no_jax():
    """Every module of the port (the data-parallel layer, the training
    and conversion entry points, the C3D encoder and the legacy backbones
    and neck among them), ``load_config`` and
    ``arch_config_from`` in a fresh interpreter: neither jax nor the JAX
    package gets imported."""
    yaml_path = os.path.join(REPO, "configs_test", "deepfake_exp12_test.yaml")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _WALK, yaml_path], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("MODULES")][-1]
    assert line.endswith("BAD []"), line
    assert "MISSING []" in out.stdout, out.stdout
    assert int(line.split()[1]) >= 30 and "INPUT_DIM 3072" in line, line


def test_yaml_list_is_not_empty():
    assert len(YAMLS) >= 2


@pytest.mark.parametrize("path", YAMLS, ids=[os.path.basename(p) for p in YAMLS])
def test_load_config_matches_jax_package(path):
    want, got = jcfg.load_config(path), tcfg.load_config(path)
    assert got == want
    assert tcfg.default_config() == jcfg.default_config()
    assert tcfg.MODEL_NAME_TO_VARIANT == jcfg.MODEL_NAME_TO_VARIANT
    assert tcfg.BACKBONE_NAME_MAP == jcfg.BACKBONE_NAME_MAP
