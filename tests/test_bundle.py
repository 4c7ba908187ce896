"""Global frame refinement (ops/bundle.py): the cv::Stitcher bundle-
adjustment analog (reference src/opencv/main.cpp:59-67; the
native reference pipelines have none). Unit tests on synthetic homography
graphs with known ground truth + the pipeline gate."""

import numpy as np
import pytest

from pano.ops import bundle


def _h(tx=0.0, ty=0.0, s=1.0, p=0.0):
    m = np.diag([s, s, 1.0])
    m[0, 2], m[1, 2] = tx, ty
    m[2, 0] = p
    return m


def _make_graph(n=4, seed=0):
    """Ground-truth globals + EXACT pairwise edges for an n-image chain
    with one cycle-closing edge (0, n-1)."""
    r = np.random.default_rng(seed)
    gt = [np.eye(3)]
    for i in range(1, n):
        # ~23% of the width per step so even the cycle-closing (0, n-1)
        # edge keeps real overlap — the refiner only constrains edges
        # inside their overlap (bundle.MIN_PTS).
        gt.append(
            gt[-1]
            @ _h(
                tx=30.0 + r.uniform(-3, 3),
                ty=r.uniform(-4, 4),
                s=1.0 + r.uniform(-0.01, 0.01),
                p=r.uniform(-1e-5, 1e-5),
            )
        )
    edges = {}
    for i in range(n - 1):
        # H_ij maps image-j coords into image-i coords: G_i @ H_ij = G_j.
        edges[(i, i + 1)] = (np.linalg.inv(gt[i]) @ gt[i + 1], 100.0)
    edges[(0, n - 1)] = (np.linalg.inv(gt[0]) @ gt[n - 1], 100.0)
    shapes = [(96, 128)] * n
    return gt, edges, shapes


def _rms_vs_truth(globals_h, gt, shapes):
    """Mean reprojection distance of each frame's grid vs ground truth."""
    errs = []
    for g, t, (h, w) in zip(globals_h, gt, shapes):
        pts = bundle._grid_points(h, w)
        errs.append(
            np.linalg.norm(
                bundle._project(g, pts) - bundle._project(t, pts), axis=1
            ).mean()
        )
    return float(np.mean(errs))


def test_refine_recovers_perturbed_globals():
    """Exact edges + perturbed initial globals: LM must pull the frames
    back to the ground truth (up to the anchor gauge, which is pinned)."""
    gt, edges, shapes = _make_graph()
    init = [g.copy() for g in gt]
    r = np.random.default_rng(1)
    for i in range(1, len(init)):
        init[i] = init[i] @ _h(
            tx=r.uniform(-8, 8), ty=r.uniform(-8, 8)
        )
    before = _rms_vs_truth(init, gt, shapes)
    refined, stats = bundle.refine_globals(init, edges, 0, shapes)
    after = _rms_vs_truth(refined, gt, shapes)
    assert before > 3.0
    assert after < 0.05, (before, after, stats)
    assert stats["rms_after"] < 1e-3


def test_refine_distributes_cycle_error():
    """A noisy chain edge + an exact cycle-closing edge: spanning-tree
    composition puts ALL the error on the last frame; refinement must
    spread it and cut the global-frame inconsistency."""
    gt, edges, shapes = _make_graph()
    n = len(gt)
    # Corrupt the chain edge (1,2) by a few pixels; MST-style composition
    # through it drifts frames 2..n-1.
    h, w_ = edges[(1, 2)]
    edges[(1, 2)] = (h @ _h(tx=4.0, ty=-3.0), w_)
    init = [np.eye(3)]
    for i in range(1, n):
        init.append(init[-1] @ edges[(i - 1, i)][0])
    before = _rms_vs_truth(init, gt, shapes)
    refined, stats = bundle.refine_globals(init, edges, 0, shapes)
    after = _rms_vs_truth(refined, gt, shapes)
    assert stats["rms_after"] < stats["rms_before"]
    assert after < before, (before, after)


def test_refine_is_identity_on_tree_graphs():
    """Chain-only (tree) graphs: the composed globals already satisfy every
    edge exactly — refinement must not change them (and the cycle gate says
    there is nothing to exploit)."""
    gt, edges, shapes = _make_graph()
    del edges[(0, len(gt) - 1)]  # drop the cycle edge -> pure chain
    init = [np.eye(3)]
    for i in range(1, len(gt)):
        init.append(init[-1] @ edges[(i - 1, i)][0])
    refined, stats = bundle.refine_globals(init, edges, 0, shapes)
    assert stats["rms_before"] < 1e-9
    for a, b in zip(init, refined):
        np.testing.assert_allclose(a, b, atol=1e-9)
    assert not bundle.graph_has_cycle(edges, len(gt), 0, init)


def test_graph_has_cycle():
    gt, edges, shapes = _make_graph()
    init = [np.eye(3)] * len(gt)
    assert bundle.graph_has_cycle(edges, len(gt), 0, init)
    # Unplaced endpoint drops its edges from the count.
    init2 = [np.eye(3), np.eye(3), np.eye(3), None]
    assert not bundle.graph_has_cycle(edges, len(gt), 0, init2)


def test_refine_never_degrades():
    """Monotonic safety: when the initial globals are already optimal the
    function returns them (same objects), never a worse solution."""
    gt, edges, shapes = _make_graph()
    refined, stats = bundle.refine_globals(list(gt), edges, 0, shapes)
    assert stats["rms_after"] <= stats["rms_before"] + 1e-12
    assert _rms_vs_truth(refined, gt, shapes) < 1e-6


def test_pipeline_gate_modes(capsys):
    """pipeline.maybe_refine_globals: 'off' is a no-op; 'auto' skips tree
    graphs; 'on' runs and prints the refinement line."""
    import dataclasses

    from pano import pipeline
    from pano.config import DEFAULT_CONFIG

    gt, edges, shapes = _make_graph()
    n = len(gt)
    counts = np.zeros((n, n), np.int64)
    for (i, j), (h, w) in edges.items():
        counts[i, j] = counts[j, i] = int(w)
    imgs = [np.zeros((96, 128, 3), np.uint8)] * n
    init = [g.copy() for g in gt]
    init[2] = init[2] @ _h(tx=5.0)

    cfg_off = DEFAULT_CONFIG.replace(
        stitch=dataclasses.replace(DEFAULT_CONFIG.stitch, bundle_adjust="off")
    )
    out = pipeline.maybe_refine_globals(
        init, counts, dict(edges_h(edges)), 0, imgs, cfg_off
    )
    assert out is init

    cfg_on = DEFAULT_CONFIG.replace(
        stitch=dataclasses.replace(DEFAULT_CONFIG.stitch, bundle_adjust="on")
    )
    out = pipeline.maybe_refine_globals(
        init, counts, dict(edges_h(edges)), 0, imgs, cfg_on
    )
    assert out is not init
    assert "Bundle refinement: rms" in capsys.readouterr().out
    # The corrupted frame moved back toward truth.
    assert _rms_vs_truth(out, gt, shapes) < _rms_vs_truth(init, gt, shapes)

    # 'auto' on a tree graph: skipped.
    tree = {k: v for k, v in edges.items() if k != (0, n - 1)}
    counts_t = np.zeros((n, n), np.int64)
    for (i, j), (h, w) in tree.items():
        counts_t[i, j] = counts_t[j, i] = int(w)
    out = pipeline.maybe_refine_globals(
        init, counts_t, dict(edges_h(tree)), 0, imgs, DEFAULT_CONFIG
    )
    assert out is init


def edges_h(edges):
    """pipeline.maybe_refine_globals takes h_edge {(i,j): H}; weights come
    from the counts matrix."""
    return {k: h for k, (h, _) in edges.items()}


def test_sharded_auto_runs_bundle_gate(capsys, monkeypatch):
    """The SHARDED auto mode must route through the same refinement gate as
    the local one (pipeline.maybe_refine_globals) — guard against the twin
    drifting."""
    import jax
    import numpy as np

    from pano import pipeline
    from pano.parallel import shard

    calls = []
    real = pipeline.maybe_refine_globals

    def spy(globals_h, counts, h_edge, root, images, config, **kw):
        calls.append(len(h_edge))
        return real(globals_h, counts, h_edge, root, images, config, **kw)

    monkeypatch.setattr(pipeline, "maybe_refine_globals", spy)

    r = np.random.default_rng(3)
    base = np.full((96, 300, 3), 30, np.uint8)
    for _ in range(160):
        y, x = r.integers(4, 88), r.integers(4, 292)
        base[y : y + 6, x : x + 6] = r.integers(60, 255, 3)
    imgs = [base[:, 0:160], base[:, 70:230], base[:, 140:300]]

    from pano.config import HarrisOptions, PanoConfig, RansacOptions

    cfg = PanoConfig(
        harris=HarrisOptions(max_keypoints=512),
        ransac=RansacOptions(num_iterations=512),
    )
    mesh = shard.make_mesh(n_data=8, n_hyp=1)
    pano = shard.stitch_all_images_auto_sharded(
        imgs, cfg, mesh=mesh, print_timing=False
    )
    assert pano is not None
    assert calls and calls[0] >= 2  # the gate saw the validated edge graph
