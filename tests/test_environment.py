"""What the program needs from its installation: the package, the CLI and
chip_smoke.py import and a PNG pair stitches with cv2, PIL and protobuf
absent, and the compile cache lives where the rule says. The package's
former import name, an alias package beside pano/, passes the same
checks."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The former import name: the one other package directory, whose __init__
# only aliases pano.
FORMER = next(
    d for d in sorted(os.listdir(REPO))
    if d.startswith("pano_") and os.path.isfile(
        os.path.join(REPO, d, "__init__.py"))
)

# A meta-path hook that makes the optional packages unimportable.
BLOCK = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("cv2", "PIL", "google"):
            raise ImportError(name + " is blocked")
        return None
sys.meta_path.insert(0, _Block())
"""


def _python(code, **env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env_extra)
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=REPO, env=env,
    )


@pytest.mark.parametrize("pkg", ["pano", FORMER])
def test_imports_without_optional_packages(pkg):
    r = _python(BLOCK + """
import {pkg}, {pkg}.cli, {pkg}.io, {pkg}.scenes, {pkg}.oracles
sys.path.insert(0, {repo!r})
import chip_smoke
for mod in ("cv2", "PIL", "google.protobuf"):
    assert mod not in sys.modules, mod
print("imported")
""".format(pkg=pkg, repo=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "imported" in r.stdout


@pytest.mark.parametrize("pkg", ["pano", FORMER])
def test_serial_png_stitch_without_optional_packages(tmp_path, pkg):
    from pano import scenes

    sc = scenes.make_scene(2, 384, 512, 1)
    a, b = scenes.write_views(sc, str(tmp_path))
    out = str(tmp_path / "pano.png")
    r = _python(BLOCK + """
from %s import cli
sys.exit(cli.main(["serial", %r, %r, "--out", %r]))
""" % (pkg, a, b, out), PANO_NATIVE="0")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    from pano.io import imread_bgr

    pano = imread_bgr(out)
    assert pano is not None and pano.shape[1] > 512
    assert np.count_nonzero(pano) > 0


def test_compile_cache_defaults_to_the_checkout():
    r = _python("import jax, pano; print(jax.config.jax_compilation_cache_dir)")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_follows_the_environment(tmp_path):
    r = _python(
        "import jax, pano; print(jax.config.jax_compilation_cache_dir)",
        JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == str(tmp_path / "cache")


def test_former_name_is_the_same_package(tmp_path):
    """Every module under the former name is the pano module itself, and
    `python -m <former>.cli gpu` refuses to run without a GPU."""
    r = _python(f"""
import pano, pano.cli, pano.ops.warp
import {FORMER}, {FORMER}.cli
from {FORMER}.ops import warp
from {FORMER}.pipeline import PairStitcher
assert {FORMER}.cli is pano.cli and warp is pano.ops.warp
assert PairStitcher is {FORMER}.PairStitcher is pano.PairStitcher
assert pano.cli.__spec__.name == "pano.cli"
print("aliased")
""")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "aliased" in r.stdout
    from pano import scenes

    a, b = scenes.write_views(scenes.make_scene(2, 96, 128, 1), str(tmp_path))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", f"{FORMER}.cli", "gpu", a, b,
         "--out", str(tmp_path / "x.png")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert r.returncode != 0
    assert "no GPU found" in r.stderr, r.stderr[-2000:]
