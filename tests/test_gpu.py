"""chip_smoke.py's checks as tests on a GPU, at the full 4156x3117 size.

They skip unless JAX sees a GPU. On a GPU machine:
    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import functools
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@functools.lru_cache(maxsize=1)
def _full_scene():
    from pano import scenes

    return scenes.make_scene(4, *chip_smoke.FULL, chip_smoke.SEED["full"])


@pytest.fixture
def views(gpu_device, tmp_path):
    """The 4-view full-size scene and its PNG files (built only once a GPU
    is known to be there)."""
    from pano import scenes

    scene = _full_scene()
    view_dir = str(tmp_path / "views")
    return scene, view_dir, scenes.write_views(scene, view_dir)


def test_ops_match_the_oracles(gpu_device, views):
    chip_smoke.ops_phase(views[0], gpu_device)


def test_pair_through_the_cli(gpu_device, views, tmp_path):
    scene, _, paths = views
    chip_smoke.pair_phase(scene, str(tmp_path), gpu_device, paths)


def test_chain_through_the_cli(gpu_device, views, tmp_path):
    scene, view_dir, _ = views
    chip_smoke.chain_phase(scene, str(tmp_path), gpu_device, view_dir)


def test_serve_answers_three_jobs(gpu_device, views, tmp_path):
    scene, _, paths = views
    chip_smoke.serve_phase(scene, str(tmp_path), paths)
