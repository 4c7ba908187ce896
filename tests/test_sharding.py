"""Multi-chip path tests on the 8-virtual-device CPU mesh (SURVEY §4:
the standard JAX answer to testing sharding without hardware)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pano.config import HarrisOptions, PanoConfig, RansacOptions
from pano.ops import match as match_ops
from pano.ops import ransac as ransac_ops
from pano.parallel import shard

SMALL = PanoConfig(
    harris=HarrisOptions(max_keypoints=512),
    ransac=RansacOptions(num_iterations=512),
)


def checkerboard_texture(h, w, seed=0):
    r = np.random.default_rng(seed)
    img = np.full((h, w, 3), 30, np.uint8)
    for _ in range(60):
        y, x = r.integers(5, h - 12), r.integers(5, w - 12)
        img[y : y + 8, x : x + 8] = r.integers(60, 255, 3)
    return img


def make_pair_batch(b, h=96, w=128, shift=32):
    lefts, rights = [], []
    for i in range(b):
        base = checkerboard_texture(h, w + shift, seed=i)
        lefts.append(base[:, shift:])
        rights.append(base[:, :w])
    return (
        jnp.asarray(np.stack(lefts), jnp.uint8),
        jnp.asarray(np.stack(rights), jnp.uint8),
    )


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8
    assert jax.default_backend() == "cpu"


def test_estimate_homographies_batched_data_parallel():
    mesh = shard.make_mesh(n_data=8, n_hyp=1)
    lefts, rights = make_pair_batch(8)
    hs, counts, ok = shard.estimate_homographies_batched(
        lefts, rights, SMALL, mesh
    )
    hs = np.asarray(hs)
    assert hs.shape == (8, 3, 3)
    assert np.asarray(ok).all()
    # Every pair is a pure x-translation by -32.
    np.testing.assert_allclose(hs[:, 0, 2], -32.0, atol=1.0)
    np.testing.assert_allclose(hs[:, 1, 2], 0.0, atol=1.0)


def test_batched_stitch_step_with_hypothesis_sharding():
    mesh = shard.make_mesh(n_data=4, n_hyp=2)
    lefts, rights = make_pair_batch(4)
    hs, counts = shard.batched_stitch_step(mesh, lefts, rights, SMALL)
    hs = np.asarray(hs)
    assert hs.shape == (4, 3, 3)
    assert (np.asarray(counts) > 10).all()
    np.testing.assert_allclose(hs[:, 0, 2], -32.0, atol=1.0)


def test_sharded_ransac_matches_quality_of_local():
    """Hypothesis sharding must find an equally good model."""
    r = np.random.default_rng(0)
    h_true = np.array([[1.0, 0.0, 20.0], [0.0, 1.0, -7.0], [0.0, 0.0, 1.0]])
    src = r.uniform(0, 500, (256, 2))
    dst = src + np.array([20.0, -7.0])
    dst[:64] += r.uniform(30, 100, (64, 2))  # outliers
    cap = 512
    pq = np.zeros((cap, 2), np.float32)
    pt = np.zeros((cap, 2), np.float32)
    pq[:256], pt[:256] = src, dst
    valid = np.zeros(cap, bool)
    valid[:256] = True

    mesh = shard.make_mesh(n_data=1, n_hyp=8)
    opts = RansacOptions(num_iterations=512)

    # Local single-shard reference.
    local = ransac_ops.ransac_homography(
        jnp.asarray(pq), jnp.asarray(pt), jnp.asarray(valid), opts
    )

    lefts = jnp.asarray(pq)[None]
    # Use the internal sharded search via _ShardedPairStitcher's builder.
    stitcher = shard._ShardedPairStitcher(
        mesh, PanoConfig(ransac=opts), timing_tag=""
    )
    res = stitcher._sharded_search(
        jnp.asarray(pq), jnp.asarray(pt), jnp.asarray(valid)
    )
    assert bool(res.ok)
    assert int(res.inlier_count) >= int(local.inlier_count) - 5
    np.testing.assert_allclose(
        np.asarray(res.H)[0, 2], 20.0, atol=0.5
    )


def test_match_descriptors_sharded_equals_local(rng):
    kq, kt, d = 64, 48, 128
    desc_q = rng.integers(0, 255, (kq, d)).astype(np.float32)
    desc_t = rng.integers(0, 255, (kt, d)).astype(np.float32)
    valid_q = rng.random(kq) > 0.2
    valid_t = rng.random(kt) > 0.2
    args = (
        jnp.asarray(desc_q),
        jnp.asarray(valid_q),
        jnp.asarray(desc_t),
        jnp.asarray(valid_t),
    )
    local = match_ops.match_descriptors(*args, 1e18)
    mesh = shard.make_mesh(n_data=8, n_hyp=1)
    sharded = shard.match_descriptors_sharded(*args, 1e18, mesh)
    np.testing.assert_array_equal(
        np.asarray(local.train_idx), np.asarray(sharded.train_idx)
    )
    np.testing.assert_array_equal(
        np.asarray(local.valid), np.asarray(sharded.valid)
    )
    np.testing.assert_allclose(
        np.asarray(local.ssd), np.asarray(sharded.ssd)
    )


def test_stitch_pairs_batched_throughput_mode():
    mesh = shard.make_mesh(n_data=4, n_hyp=1)
    lefts, rights = make_pair_batch(4)
    panos = shard.stitch_pairs_batched(lefts, rights, SMALL, mesh)
    assert len(panos) == 4
    for p in panos:
        assert p is not None
        assert p.shape[1] >= 150  # 128 + ~32 shift


def test_stitch_all_images_sharded_end_to_end():
    base = checkerboard_texture(96, 224, seed=5)
    imgs = [base[:, :128].copy(), base[:, 96:224].copy()]
    pano = shard.stitch_all_images_sharded(imgs, SMALL, timing_tag="Sharded")
    assert pano is not None
    assert pano.shape[1] >= 220


def test_fused_estimate_batched_packed_protocol():
    """Sharded fused protocol returns the pipeline's packed layout."""
    mesh = shard.make_mesh(n_data=8, n_hyp=1)
    lefts, rights = make_pair_batch(8)
    packed, pts = shard.fused_estimate_batched(lefts, rights, SMALL, mesh)
    v = np.asarray(packed)                  # one fetch for the whole batch
    assert v.shape == (8, 14)
    assert (v[:, 11] > 0.5).all()           # ok flag
    assert (v[:, 12] > 8).all()             # match counts
    hs = v[:, :9].reshape(8, 3, 3)
    np.testing.assert_allclose(hs[:, 0, 2], -32.0, atol=1.0)


def test_composite_pairs_batched_matches_per_pair_composite():
    """Bucketed batched compositing == the per-pair composite path."""
    from pano.pipeline import PairStitcher

    mesh = shard.make_mesh(n_data=4, n_hyp=1)
    lefts, rights = make_pair_batch(4)
    hs, counts, ok = shard.estimate_homographies_batched(
        lefts, rights, SMALL, mesh
    )
    hs = np.asarray(hs, np.float64)
    ok = np.asarray(ok)
    batched = shard.composite_pairs_batched(
        lefts, rights, hs, ok, SMALL, mesh
    )
    stitcher = PairStitcher(SMALL, print_timing=False)
    for b in range(4):
        ref = np.asarray(stitcher.composite(lefts[b], rights[b], hs[b]))
        assert batched[b] is not None
        np.testing.assert_array_equal(batched[b], ref)


def test_stitch_all_images_chain_sharded():
    """Chain mode: one sharded batch dispatch for all adjacent pairs."""
    base = checkerboard_texture(96, 320, seed=7)
    imgs = [
        base[:, 0:128].copy(),
        base[:, 64:192].copy(),
        base[:, 128:256].copy(),
        base[:, 192:320].copy(),
    ]
    mesh = shard.make_mesh(n_data=8, n_hyp=1)
    pano = shard.stitch_all_images_chain_sharded(
        imgs, SMALL, timing_tag="Sharded", mesh=mesh
    )
    assert pano is not None
    # Four 128-wide images with 64-px steps span ~320 columns.
    assert pano.shape[1] >= 310
    assert pano.shape[0] >= 90


def test_stitch_all_images_auto_sharded_unordered():
    """Sharded auto mode: all-pairs estimates in one sharded dispatch must
    recover the panorama from SHUFFLED input order."""
    base = checkerboard_texture(96, 320, seed=11)
    imgs = [
        base[:, 128:256].copy(),   # middle-right first
        base[:, 0:128].copy(),     # leftmost
        base[:, 192:320].copy(),   # rightmost
        base[:, 64:192].copy(),    # middle-left
    ]
    mesh = shard.make_mesh(n_data=2, n_hyp=1)
    pano = shard.stitch_all_images_auto_sharded(
        imgs, SMALL, timing_tag="Sharded", mesh=mesh
    )
    assert pano is not None
    assert pano.shape[1] >= 310
    # Content check: the panorama interior must match the base texture.
    ref = pano[:90, :310].astype(int)
    d = np.abs(ref - base[:90, :310].astype(int)).max(-1)
    assert (d > 30).mean() < 0.08, (d > 30).mean()


def test_stitch_all_images_auto_sharded_matches_local():
    """Sharded and local auto modes must place the same images (same MST)."""
    from pano import pipeline

    base = checkerboard_texture(96, 256, seed=13)
    imgs = [
        base[:, 128:256].copy(),
        base[:, 0:128].copy(),
        base[:, 64:192].copy(),
    ]
    mesh = shard.make_mesh(n_data=1, n_hyp=1)
    p_sh = shard.stitch_all_images_auto_sharded(imgs, SMALL, mesh=mesh)
    p_lo = pipeline.stitch_all_images_auto(imgs, SMALL, print_timing=False)
    assert p_sh is not None and p_lo is not None
    assert p_sh.shape == p_lo.shape
    d = np.abs(p_sh.astype(int) - p_lo.astype(int)).max()
    assert d <= 1, d  # identical graphs up to f32 scheduling


def test_stitch_all_images_chain_sharded_skips_failed_image():
    """A featureless middle image must be skipped with the fold's re-anchor
    semantics (src/serial/main.cpp:404-407), same as the local chain."""
    base = checkerboard_texture(96, 224, seed=15)
    flat = np.zeros((96, 128, 3), np.uint8)
    imgs = [base[:, 0:128].copy(), flat, base[:, 96:224].copy()]
    mesh = shard.make_mesh(n_data=2, n_hyp=1)
    pano = shard.stitch_all_images_chain_sharded(
        imgs, SMALL, timing_tag="Sharded", mesh=mesh
    )
    assert pano is not None
    assert pano.shape[1] >= 210  # image 3 re-anchored against image 1


def test_stitch_all_images_sharded_mode_dispatch():
    base = checkerboard_texture(96, 224, seed=9)
    imgs = [base[:, :128].copy(), base[:, 96:224].copy()]
    pano = shard.stitch_all_images_sharded(
        imgs, SMALL, timing_tag="Sharded", mode="chain"
    )
    assert pano is not None
    assert pano.shape[1] >= 220


def _chain_globals(n_imgs, step):
    """Pure x-translation chain: image i sits at x = i*step."""
    gs = [np.eye(3)]
    for i in range(1, n_imgs):
        h = np.eye(3)
        h[0, 2] = i * step
        gs.append(h)
    return gs


def _weight_canvas_oracle(imgs, globals_h, shape):
    """Accumulated feather coverage of a global composite in numpy: the
    anchor's edge ramp, then per image the max with its resampled 8-bit
    ramp times its in-bounds weight (pano.oracles semantics)."""
    from pano import oracles

    h, w = imgs[0].shape[:2]
    want = np.zeros(shape)
    want[:h, :w] = oracles.edge_ramp(h, w)
    for img, g in zip(imgs[1:], globals_h[1:]):
        hi, wi = img.shape[:2]
        ramp = (oracles.edge_ramp(hi, wi)[..., None] * 255.0).astype(
            np.uint8)
        r, inb = oracles._sample_through(ramp, np.linalg.inv(g), *shape)
        want = np.maximum(want, r[..., 0] / 255.0 * inb)
    return want


@pytest.mark.parametrize("blend", ["overlay", "feather", "multiband"])
def test_composite_global_sharded_matches_local(blend):
    """The mesh-batched global composite must reproduce the sequential
    local composite, and its accumulated weight canvas the numpy one."""
    from dataclasses import replace
    from pano import pipeline

    base = checkerboard_texture(96, 384, seed=21)
    imgs = [base[:, i * 64 : i * 64 + 128].copy() for i in range(5)]
    globals_h = _chain_globals(5, 64)
    cfg = replace(SMALL, stitch=replace(SMALL.stitch, blend=blend))
    devs = [jnp.asarray(im, jnp.uint8) for im in imgs]

    mesh = shard.make_mesh(n_data=4, n_hyp=1)
    w_sh = []
    p_sh = shard.composite_global_sharded(
        imgs, devs, globals_h, cfg, mesh=mesh, _weights_out=w_sh
    )
    p_lo = pipeline.composite_global(imgs, devs, globals_h, cfg)
    assert p_sh is not None and p_lo is not None
    assert p_sh.shape == p_lo.shape
    d = np.abs(p_sh.astype(int) - p_lo.astype(int))
    assert (d > 2).mean() < 0.001, (d > 2).mean()
    np.testing.assert_allclose(
        w_sh[0], _weight_canvas_oracle(imgs, globals_h, p_sh.shape[:2]),
        atol=0.02,
    )


def test_composite_global_sharded_warps_in_one_sharded_dispatch():
    """Compositing must scale with the mesh — the
    per-image warps run as ONE vmapped dispatch whose batch axis is
    sharded over 'data', not a per-image loop on one device."""
    mesh = shard.make_mesh(n_data=4, n_hyp=1)
    base = checkerboard_texture(96, 384, seed=22)
    imgs = jnp.stack(
        [jnp.asarray(base[:, i * 64 : i * 64 + 128], jnp.uint8)
         for i in range(4)]
    )
    m_invs = jnp.asarray(
        np.stack([np.eye(3)] * 4), jnp.float32
    )
    origins = jnp.zeros((4, 2), jnp.float32)
    wins, weights = shard.warp_windows_batched(
        imgs, m_invs, origins, 128, 256, mesh
    )
    assert wins.shape == (4, 128, 256)
    # The batch axis must actually be sharded over the 4 'data' devices.
    assert len(wins.sharding.device_set) == 4
    assert len(weights.sharding.device_set) == 4


def test_sharded_auto_single_fetch(monkeypatch):
    """The sharded auto mode must pay exactly ONE host fetch for the whole
    n(n-1)/2 match graph (packed rows), like its local twin."""
    from pano import pipeline

    base = checkerboard_texture(96, 256, seed=31)
    imgs = [
        base[:, 64:192].copy(),
        base[:, 0:128].copy(),
        base[:, 128:256].copy(),
    ]
    calls = []
    real_fetch = pipeline._host_fetch
    monkeypatch.setattr(
        pipeline, "_host_fetch", lambda x: (calls.append(1), real_fetch(x))[1]
    )
    mesh = shard.make_mesh(n_data=2, n_hyp=1)
    pano = shard.stitch_all_images_auto_sharded(
        imgs, SMALL, mesh=mesh, print_timing=False
    )
    assert pano is not None
    assert len(calls) == 1, f"expected 1 packed fetch, saw {len(calls)}"


def test_dryrun_multichip_certifies_shipped_spmd_step():
    """The multi-device dry run must exercise the SHIPPED code:
    __graft_entry__.dryrun_multichip's homographies must be
    byte-identical to a direct shard.batched_stitch_step call on the same
    inputs — if the entry ever hand-rolls its own SPMD twin again, this
    drifts and fails."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(repo, "__graft_entry__.py")
    )
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)

    hs_entry, counts_entry = ge.dryrun_multichip(8)

    mesh, cfg, lefts, rights = ge._dryrun_setup(8)
    hs_lib, counts_lib = shard.batched_stitch_step(mesh, lefts, rights, cfg)
    np.testing.assert_array_equal(hs_entry, np.asarray(hs_lib, np.float64))
    np.testing.assert_array_equal(counts_entry, np.asarray(counts_lib))
    assert (counts_entry > 0).all()


def _mild_batch_homographies(n, win_h, win_w):
    """Per-image in-envelope inverse maps + window origins for a batch."""
    ms, origins = [], []
    for k in range(n):
        m = np.eye(3)
        m[0, 2] = 4.5 * k - 6.0
        m[1, 2] = 1.5 * k
        m[2, 0] = 1e-5 * (k - 1)
        ms.append(np.linalg.inv(m))
        origins.append([0.0, 0.0])
    return np.stack(ms), np.array(origins, np.float64)


def test_warp_windows_batched_matches_oracle():
    """The batched window warp against the float64 oracle on the same
    per-image maps and window origins: packed RGB within 1 per channel,
    the feather weight within one 8-bit ramp step."""
    from pano import oracles

    base = checkerboard_texture(96, 384, seed=23)
    imgs = np.stack([base[:, i * 64 : i * 64 + 160] for i in range(3)])
    m_invs, origins = _mild_batch_homographies(3, 128, 256)
    origins[1] = [5.0, 3.0]
    wins, weights = shard.warp_windows_batched(
        jnp.asarray(imgs), m_invs, origins, 128, 256, mesh=None
    )
    wins, weights = np.asarray(wins), np.asarray(weights)
    hr, wr = imgs.shape[1:3]
    ramp = (oracles.edge_ramp(hr, wr)[..., None] * 255.0).astype(np.uint8)
    for b in range(3):
        shift = np.array([[1.0, 0.0, origins[b, 0]],
                          [0.0, 1.0, origins[b, 1]], [0.0, 0.0, 1.0]])
        m_win = m_invs[b] @ shift
        want = oracles.warp_u8(imgs[b], m_win, 128, 256)
        got = np.stack([(wins[b] >> s) & 0xFF for s in (0, 8, 16)], -1)
        assert np.abs(got - want.astype(int)).max() <= 1, b
        r, inb = oracles._sample_through(ramp, m_win, 128, 256)
        np.testing.assert_allclose(
            weights[b], r[..., 0] / 255.0 * inb, atol=1.0 / 255.0 + 1e-6
        )


def test_warp_windows_batched_sharded_dispatch():
    """Sharded over the 4-device 'data' axis, the batched warp returns
    exactly the single-device result, with its batch axis on 4 devices."""
    mesh = shard.make_mesh(n_data=4, n_hyp=1)
    base = checkerboard_texture(96, 384, seed=24)
    imgs = jnp.stack(
        [jnp.asarray(base[:, i * 48 : i * 48 + 160], jnp.uint8)
         for i in range(4)]
    )
    m_invs, origins = _mild_batch_homographies(4, 128, 256)
    wins, weights = shard.warp_windows_batched(
        imgs, m_invs, origins, 128, 256, mesh=mesh
    )
    wins_1, weights_1 = shard.warp_windows_batched(
        imgs, m_invs, origins, 128, 256, mesh=None
    )
    assert wins.shape == (4, 128, 256)
    assert len(wins.sharding.device_set) == 4
    np.testing.assert_array_equal(np.asarray(wins), np.asarray(wins_1))
    np.testing.assert_array_equal(np.asarray(weights), np.asarray(weights_1))


@pytest.mark.parametrize("step", [64.0, 63.5])
def test_composite_global_sharded_matches_oracle(step):
    """The sharded overlay global composite against the numpy oracle:
    the anchor placed, then each warped image composited on top in order
    (pano.oracles.compose with the canvas as its left image)."""
    from dataclasses import replace

    from pano import oracles

    base = checkerboard_texture(96, 384, seed=25)
    imgs = [base[:, i * 64 : i * 64 + 128].copy() for i in range(5)]
    globals_h = _chain_globals(5, step)
    cfg = replace(SMALL, stitch=replace(SMALL.stitch, blend="overlay"))
    devs = [jnp.asarray(im, jnp.uint8) for im in imgs]
    mesh = shard.make_mesh(n_data=4, n_hyp=1)
    got = shard.composite_global_sharded(
        imgs, devs, globals_h, cfg, mesh=mesh
    )
    assert got is not None
    want = np.zeros_like(got)
    want[:96, :128] = imgs[0]
    ch, cw = got.shape[:2]
    for img, g in zip(imgs[1:], globals_h[1:]):
        want = oracles.compose(want, img, np.linalg.inv(g), 0, 0, ch, cw)
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (d > 1).mean() < 1e-3, (d.max(), (d > 1).mean())


def test_composite_pairs_batched_matches_oracle():
    """Throughput-mode compositing over the mesh against the numpy overlay
    oracle on each pair's estimated homography."""
    from pano import oracles
    from pano.ops import warp as warp_ops

    mesh = shard.make_mesh(n_data=4, n_hyp=1)
    lefts, rights = make_pair_batch(4)
    hs, counts, ok = shard.estimate_homographies_batched(
        lefts, rights, SMALL, mesh
    )
    hs = np.asarray(hs, np.float64)
    ok = np.asarray(ok)
    assert ok.all()
    panos = shard.composite_pairs_batched(lefts, rights, hs, ok, SMALL, mesh)
    for b in range(4):
        left, right = np.asarray(lefts[b]), np.asarray(rights[b])
        (ch, cw), t_mat, (mx, my) = warp_ops.compute_canvas_geometry(
            hs[b], left.shape[:2], right.shape[:2]
        )
        want = oracles.compose(
            left, right, np.linalg.inv(t_mat @ hs[b]),
            warp_ops.left_offset(mx), warp_ops.left_offset(my), ch, cw,
        )
        assert panos[b] is not None and panos[b].shape == want.shape
        d = np.abs(panos[b].astype(int) - want.astype(int)).max(-1)
        assert (d > 1).mean() < 1e-3, (b, d.max(), (d > 1).mean())


# ---------------------------------------------------------------------------
# Hermetic-placement regression tests: an eager uncommitted constant in a
# sharded path dispatches to the DEFAULT backend even when the mesh is on
# other devices (a virtual-CPU mesh in a process whose default is a GPU).
# The CPU-only suite cannot reproduce two-platform straying directly, so it
# enforces the invariant that prevents it: the SPMD paths perform no
# implicit transfers at all — every host->device move is an explicit
# device_put.
# ---------------------------------------------------------------------------


def test_certified_spmd_paths_are_transfer_guard_clean():
    """batched_stitch_step + composite_pairs_batched (the exact pair the
    multi-device dry run certifies) run start-to-finish under
    jax.transfer_guard('disallow'): any eager uncommitted constant or
    implicit jit-argument transfer raises."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = shard.make_mesh(n_data=4, n_hyp=2)
    lefts, rights = make_pair_batch(4)
    spec = NamedSharding(mesh, P("data"))
    lefts = jax.device_put(lefts, spec)
    rights = jax.device_put(rights, spec)

    with jax.transfer_guard("disallow"):
        hs_d, counts_d = shard.batched_stitch_step(mesh, lefts, rights, SMALL)
        hs = np.asarray(hs_d, np.float64)
        counts = np.asarray(counts_d)
        assert (counts > 0).all()
        panos = shard.composite_pairs_batched(
            lefts, rights, hs, np.ones(4, bool), SMALL, mesh
        )
    for p in panos:
        assert p is not None and p.ndim == 3


def test_composite_pairs_batched_guard_clean_with_partial_groups():
    """Heterogeneous canvas buckets split the batch into groups that don't
    divide the mesh; the partial-group route (jitted row gather +
    single-device dispatch) must be transfer-clean too — and later groups
    must NOT lose the mesh to an earlier partial group (a `mesh = None`
    reassignment would demote every later group)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = shard.make_mesh(n_data=4, n_hyp=1)
    lefts, rights = make_pair_batch(4)
    hs, counts, ok = shard.estimate_homographies_batched(
        lefts, rights, SMALL, mesh
    )
    hs = np.asarray(hs, np.float64)
    ok = np.asarray(ok)
    assert ok.all()
    # Skew one pair's homography so its canvas buckets differently,
    # producing a 1-pair group and a 3-pair group (neither divides 4).
    hs_split = hs.copy()
    hs_split[0] = hs_split[0] @ np.diag([1.35, 1.35, 1.0])
    spec = NamedSharding(mesh, P("data"))
    lefts = jax.device_put(lefts, spec)
    rights = jax.device_put(rights, spec)
    with jax.transfer_guard("disallow"):
        panos = shard.composite_pairs_batched(
            lefts, rights, hs_split, ok, SMALL, mesh
        )
    shapes = {p.shape for p in panos if p is not None}
    assert len([p for p in panos if p is not None]) == 4
    assert len(shapes) >= 2, shapes  # the split actually happened

    # Reference: same inputs, no guard, local per-pair composite.
    ref = shard.composite_pairs_batched(
        np.asarray(lefts), np.asarray(rights), hs_split, ok, SMALL, None
    )
    for b in range(4):
        assert panos[b].shape == ref[b].shape
        np.testing.assert_array_equal(panos[b], ref[b])


def test_dryrun_multichip_is_hermetic_under_transfer_guard():
    """The multi-device dry run end-to-end under
    transfer_guard('disallow'): it cannot eagerly dispatch to a default
    backend it doesn't own (an eager convert_element_type would)."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "graft_entry_guard", os.path.join(repo, "__graft_entry__.py")
    )
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)

    with jax.transfer_guard("disallow"):
        hs, counts = ge.dryrun_multichip(8)
    assert hs.shape[1:] == (3, 3)
    assert (counts > 0).all()
