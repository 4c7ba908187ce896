"""Golden-quality integration gate on seeded scenes with known geometry.

The reference grades its panoramas with `pano.sh eval` against committed
reference panoramas (reference evaluate_panorama.py:68-119,
README.md:120-134). Here the scenes come from pano.scenes, whose true
homographies give exact gates: every estimated pair homography must send
the image corners within 1 px of the truth (the evaluator's "Good"
alignment grade), and the panorama must reproduce the true render of the
world over the warped views (PSNR >= 25 dB).

The CPU cases run the 4-view chain at 512x384; the `gpu` variant runs the
full 4156x3117 views on a GPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from pano import pipeline, scenes
from pano.config import DEFAULT_CONFIG

SIZE = (384, 512)
SEED = 1
CORNER_PX = 1.0
PSNR_DB = 25.0


@pytest.fixture(scope="module")
def scene():
    return scenes.make_scene(4, SIZE[0], SIZE[1], SEED)


def _config(blend: str):
    return DEFAULT_CONFIG.replace(
        stitch=dataclasses.replace(DEFAULT_CONFIG.stitch, blend=blend)
    )


def _grade_chain(scene, pano, cfg):
    """Corner error of every adjacent estimate and the PSNR of `pano`
    against the true render over the warped (non-anchor) views."""
    h, w = SIZE
    stitcher = pipeline.get_pair_stitcher(cfg, False, "")
    globals_h = [np.eye(3)]
    errs = []
    for i in range(1, len(scene.views)):
        h_est = stitcher.estimate_homography(scene.views[i - 1],
                                             scene.views[i])
        assert h_est is not None, f"pair {i - 1}-{i} failed"
        errs.append(scenes.corner_error(
            h_est, scenes.pair_homography(scene, i - 1, i), h, w))
        globals_h.append(globals_h[-1] @ h_est)
    t_mat, ch, cw, _, _ = pipeline.global_canvas_geometry(
        scene.views, globals_h, 0, cfg.stitch.canvas_bucket
    )
    assert pano.shape == (ch, cw, 3), (pano.shape, ch, cw)
    truth = scenes.truth_canvas(scene, 0, t_mat, ch, cw)
    region = np.zeros((ch, cw), bool)
    for i in range(1, len(scene.views)):
        region |= scenes.footprint(
            t_mat @ scenes.pair_homography(scene, 0, i), h, w, ch, cw)
    region &= ~scenes.footprint(t_mat, h, w, ch, cw, erode=-2)
    return max(errs), scenes.psnr(pano, truth, region)


@pytest.mark.parametrize("blend", ["overlay", "feather", "multiband"])
def test_golden_scene_quality(scene, blend):
    cfg = _config(blend)
    pano = pipeline.stitch_all_images(
        scene.views, config=cfg, print_timing=False, mode="chain"
    )
    assert pano is not None
    err, db = _grade_chain(scene, pano, cfg)
    assert err <= CORNER_PX, err
    assert db >= PSNR_DB, db


@pytest.mark.gpu
def test_golden_scene_quality_gpu_fullres(gpu_device):
    """The full-size 4-view chain on the GPU, multiband."""
    full = scenes.make_scene(4, 3117, 4156, 0)
    cfg = _config("multiband")
    pano = pipeline.stitch_all_images(
        full.views, config=cfg, print_timing=False, mode="chain",
        device=gpu_device,
    )
    assert pano is not None
    h, w = full.views[0].shape[:2]
    stitcher = pipeline.get_pair_stitcher(cfg, False, "")
    for i in range(1, 4):
        h_est = stitcher.estimate_homography(full.views[i - 1],
                                             full.views[i])
        err = scenes.corner_error(
            h_est, scenes.pair_homography(full, i - 1, i), h, w)
        assert err <= CORNER_PX, (i, err)


# ---------------------------------------------------------------------------
# The same gates through the SHARDED product paths: real scenes must flow
# through batched_stitch_step -> composite_pairs_batched and the sharded
# chain, not only square synthetic parity inputs. Reference analog:
# pano.sh eval gates every implementation (reference pano.sh:246-278).
# ---------------------------------------------------------------------------


def test_golden_sharded_chain(scene):
    """The sharded chain product path (fused_estimate_batched ->
    composite_global_sharded) graded like the local chain, and equal to
    the local chain panorama within +-2."""
    from pano.parallel import shard

    cfg = _config("overlay")
    mesh = shard.make_mesh(n_data=4, n_hyp=1)
    pano = shard.stitch_all_images_chain_sharded(
        scene.views, cfg, mesh=mesh, print_timing=False
    )
    assert pano is not None
    err, db = _grade_chain(scene, np.asarray(pano), cfg)
    assert err <= CORNER_PX, err
    assert db >= PSNR_DB, db
    local = pipeline.stitch_all_images(
        scene.views, config=cfg, print_timing=False, mode="chain"
    )
    d = np.abs(np.asarray(pano).astype(int) - local.astype(int))
    assert (d > 2).mean() < 1e-3, (d > 2).mean()


def test_golden_throughput_pairs_match_local_pipeline(scene):
    """The dry-run-certified throughput path (batched_stitch_step ->
    composite_pairs_batched) on the scene's pairs over a (4 data x 2 hyp)
    mesh: each pair's homography meets the corner gate and each SPMD
    panorama equals the local single-device stitch of the same pair
    within +-2 (any placement, sharding or routing drift shows here)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pano.parallel import shard

    pairs = [(0, 1), (1, 2), (2, 3), (1, 0)]
    lefts = np.stack([scene.views[i] for i, _ in pairs])
    rights = np.stack([scene.views[j] for _, j in pairs])
    cfg = DEFAULT_CONFIG
    mesh = shard.make_mesh(n_data=4, n_hyp=2)
    spec = NamedSharding(mesh, P("data"))
    lefts_d = jax.device_put(lefts, spec)
    rights_d = jax.device_put(rights, spec)
    hs_d, counts_d = shard.batched_stitch_step(mesh, lefts_d, rights_d, cfg)
    hs = np.asarray(hs_d, np.float64)
    assert (np.asarray(counts_d) >= cfg.ransac.min_inliers).all()
    panos = shard.composite_pairs_batched(
        lefts_d, rights_d, hs, np.ones(4, bool), cfg, mesh
    )
    stitcher = pipeline.get_pair_stitcher(cfg, False, "")
    for k, (i, j) in enumerate(pairs):
        err = scenes.corner_error(
            hs[k], scenes.pair_homography(scene, i, j), *SIZE)
        assert err <= CORNER_PX, (k, err)
        local = np.asarray(stitcher.composite(
            jax.numpy.asarray(scene.views[i]),
            jax.numpy.asarray(scene.views[j]), hs[k]))
        assert panos[k] is not None and panos[k].shape == local.shape
        d = np.abs(panos[k].astype(int) - local.astype(int))
        assert (d > 2).mean() < 1e-3, (k, (d > 2).mean())
