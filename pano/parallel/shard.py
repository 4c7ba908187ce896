"""shard_map/pjit execution configs: the multi-device counterpart of the
reference's OpenMP/CUDA paths.

Three first-class sharding strategies (see package docstring and SURVEY §2.6):

  * `estimate_homographies_batched` / `stitch_pairs_batched` — batch-of-pairs
    data parallelism over a 'data' mesh axis (throughput mode; no reference
    analog, demanded by the north-star configs).
  * `batched_stitch_step` — the full SPMD step: pairs sharded over 'data',
    RANSAC hypotheses sharded over 'hyp', per-pair winners combined with an
    `all_gather` + argmax over the 'hyp' axis. This is the counterpart of
    the OpenMP per-thread best-H arrays + serial argmax reduction
    (src/openmp/main.cpp:379-442), with device collectives instead of
    shared memory.
  * `match_descriptors_sharded` — query rows of the SSD distance problem
    sharded over devices, train side replicated (the K x K matrix never
    materializes globally; cf. the CUDA full-matrix allocation at
    src/gpu/harris_matcher.cu:127).

All functions accept an explicit `jax.sharding.Mesh`; tests drive them on an
8-virtual-device CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count).
Every device sees every other at the same rate (NVLink joins all GPUs of a
host), so the mesh shape follows the algorithm alone: 'data' for batches of
independent pairs, 'hyp' for RANSAC hypotheses.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from contextlib import nullcontext
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pano import pipeline
from pano.config import DEFAULT_CONFIG, PanoConfig
from pano.ops import harris as harris_ops
from pano.ops import match as match_ops
from pano.ops import ransac as ransac_ops
from pano.timer import Timer, print_stage


def make_mesh(
    n_data: Optional[int] = None, n_hyp: int = 1
) -> Mesh:
    """Build a ('data', 'hyp') mesh over the available devices."""
    n_total = len(jax.devices())
    if n_data is None:
        n_data = n_total // n_hyp
    # Auto axis types: we annotate boundaries (device_put / shard_map) and
    # let the partitioner propagate, rather than threading explicit
    # sharding-in-types through the whole pipeline.
    return jax.make_mesh(
        (n_data, n_hyp),
        ("data", "hyp"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2,
    )


def _mesh_scope(mesh: Optional[Mesh]):
    """`jax.default_device` scope pinning EAGER/uncommitted placement to the
    mesh's own devices.

    Uncommitted host constants (`jnp.asarray` of Python lists, `jnp.zeros`,
    eager scalar casts) otherwise land on the DEFAULT device, which need not
    belong to the mesh (a virtual-CPU mesh in a process whose default
    backend is a GPU, or a sub-mesh of the cards). Every sharded entry point
    opens this scope so nothing it creates strays off the mesh; arrays
    created inside remain UNCOMMITTED, so jit/shard_map resharding still
    applies. tests/test_sharding.py runs the sharded paths under
    jax.transfer_guard("disallow") to keep implicit transfers out."""
    if mesh is None:
        return nullcontext()
    return jax.default_device(next(iter(mesh.devices.flat)))


# --------------------------------------------------------------------------
# Pure per-pair homography core (shared by all sharded entry points)
# --------------------------------------------------------------------------

def _pair_points(left, right, harris_opts):
    """Detect + match one pair; returns compacted match points.

    Matching direction follows the pipeline: right image is the query, left
    the train, so H maps right->left (src/serial/main.cpp:319-328).
    """
    kps_l = harris_ops.harris_detect(left, harris_opts)
    kps_r = harris_ops.harris_detect(right, harris_opts)
    m = match_ops.match_keypoints(kps_r, kps_l, right, left, harris_opts)
    return match_ops.gather_match_points(kps_r, kps_l, m)


def estimate_homographies_batched(
    lefts: jnp.ndarray,          # (B, H, W, 3) uint8
    rights: jnp.ndarray,         # (B, H, W, 3) uint8
    config: PanoConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batch of pairs -> (H (B,3,3), inlier_count (B,), ok (B,)).

    Pure data parallelism: the batch axis is sharded over the mesh's 'data'
    axis via sharding annotations; XLA partitions the whole
    detect->match->RANSAC graph with no collectives.
    """
    h_opts, r_opts = config.harris, config.ransac

    def one(left, right):
        pq, pt, v = _pair_points(left, right, h_opts)
        res = ransac_ops.ransac_homography(pq, pt, v, r_opts)
        return res.H, res.inlier_count, res.ok

    fn = jax.vmap(one)
    if mesh is not None:
        spec = NamedSharding(mesh, P("data"))
        lefts = jax.device_put(lefts, spec)
        rights = jax.device_put(rights, spec)
        fn = jax.jit(
            fn,
            in_shardings=(spec, spec),
            out_shardings=(
                NamedSharding(mesh, P("data")),
                NamedSharding(mesh, P("data")),
                NamedSharding(mesh, P("data")),
            ),
        )
    else:
        fn = jax.jit(fn)
    return fn(lefts, rights)


def batched_stitch_step(
    mesh: Mesh,
    lefts: jnp.ndarray,
    rights: jnp.ndarray,
    config: PanoConfig = DEFAULT_CONFIG,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full SPMD pipeline step under shard_map: ('data' x 'hyp') mesh.

    Each device processes B/n_data pairs and num_iterations/n_hyp RANSAC
    hypotheses; winners are combined with all_gather over 'hyp'. Returns
    (H (B,3,3), inlier_count (B,)) with the batch axis sharded over 'data'.
    """
    h_opts, r_opts = config.harris, config.ransac
    n_hyp = mesh.shape["hyp"]
    n_data = mesh.shape["data"]
    b = lefts.shape[0]
    if b % n_data != 0:
        raise ValueError(f"batch {b} not divisible by data axis {n_data}")
    if r_opts.num_iterations % n_hyp != 0:
        raise ValueError("num_iterations not divisible by hyp axis")
    iters_local = r_opts.num_iterations // n_hyp

    def per_pair(left, right, hyp_idx):
        pq, pt, v = _pair_points(left, right, h_opts)
        key = jax.random.fold_in(jax.random.PRNGKey(r_opts.seed), hyp_idx)
        best_h, best_count = ransac_ops.ransac_best_hypothesis(
            key, pq, pt, v,
            iters_local, r_opts.num_samples, r_opts.distance_threshold,
        )
        return best_h, best_count, pq, pt, v

    def spmd(lefts_l, rights_l):
        hyp_idx = lax.axis_index("hyp")
        best_h, best_count, pq, pt, v = jax.vmap(
            lambda l, r: per_pair(l, r, hyp_idx)
        )(lefts_l, rights_l)

        # Combine disjoint hypothesis streams: all_gather over 'hyp' + argmax
        # (a device collective replacing the OpenMP serial argmax reduction).
        all_h = lax.all_gather(best_h, "hyp")        # (n_hyp, b_l, 3, 3)
        all_c = lax.all_gather(best_count, "hyp")    # (n_hyp, b_l)
        win = jnp.argmax(all_c, axis=0)              # (b_l,)
        h_best = jnp.take_along_axis(
            all_h, win[None, :, None, None], axis=0
        )[0]
        c_best = jnp.take_along_axis(all_c, win[None, :], axis=0)[0]

        # Finalize (guard + inlier mask + refine) — replicated over 'hyp'.
        res = jax.vmap(
            lambda hh, cc, a, bb, vv: ransac_ops.finalize_ransac(
                hh, cc, a, bb, vv, r_opts
            )
        )(h_best, c_best, pq, pt, v)
        return res.H, res.inlier_count

    fn = jax.shard_map(
        spmd,
        mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")),
        check_vma=False,
    )
    return jax.jit(fn)(lefts, rights)


def fused_estimate_batched(
    lefts: jnp.ndarray,          # (B, H, W, 3) uint8
    rights: jnp.ndarray,         # (B, H, W, 3) uint8
    config: PanoConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
):
    """The single-dispatch fused estimation protocol (pipeline.PairStitcher.
    _fused_estimate_impl), batched and sharded over the 'data' mesh axis.

    Returns (packed (B, 14) f32 on device, (pts_q, pts_t, valid) on device).
    Packed layout per pair matches the pipeline's fused protocol:
    [H.ravel() (9), inlier_count, num_matches, ok, match_count]. The caller
    fetches `packed` with ONE host round trip for the whole batch; match
    points stay on device for the rare low-inlier OpenCV-fallback path.
    """
    h_opts, r_opts = config.harris, config.ransac

    def one(left, right):
        pq, pt, v = _pair_points(left, right, h_opts)
        res = ransac_ops.ransac_homography(pq, pt, v, r_opts)
        packed = jnp.concatenate(
            [
                res.H.reshape(-1).astype(jnp.float32),
                jnp.stack(
                    [
                        res.inlier_count.astype(jnp.float32),
                        res.num_matches.astype(jnp.float32),
                        res.ok.astype(jnp.float32),
                        jnp.sum(v.astype(jnp.float32)),  # match count
                        jnp.float32(0.0),  # reserved — keeps the row layout
                        #                    identical to the pipeline's
                        #                    (14,) fused protocol
                    ]
                ),
            ]
        )
        return packed, (pq, pt, v)

    fn = jax.vmap(one)
    if mesh is not None:
        spec = NamedSharding(mesh, P("data"))
        lefts = jax.device_put(lefts, spec)
        rights = jax.device_put(rights, spec)
        fn = jax.jit(fn, in_shardings=(spec, spec))
    else:
        fn = jax.jit(fn)
    return fn(lefts, rights)


def composite_pairs_batched(
    lefts: jnp.ndarray,
    rights: jnp.ndarray,
    hs: np.ndarray,              # (B, 3, 3) float64, right->left
    ok: np.ndarray,              # (B,) bool
    config: PanoConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
) -> List[Optional[np.ndarray]]:
    """Batched warp+blend: pairs whose bucketed (canvas, window) sizes agree
    run as ONE vmapped dispatch, sharded over 'data' when the group divides
    the mesh — the compositing half of throughput mode scales with device
    count instead of looping on the host (canvas geometry itself stays host
    3x3 math, as in PairStitcher.composite)."""
    from pano.ops import warp as warp_ops

    cfg = config.stitch
    hr, wr = int(rights.shape[1]), int(rights.shape[2])
    b_total = int(lefts.shape[0])

    def _r(x, m):
        return ((x + m - 1) // m) * m

    # Host-side canvas geometry per pair; group by the static dims. Shapes
    # come from the BATCH arrays (an eager `lefts[b]` slice of a device
    # array would dispatch — and transfer its index — to the default
    # device; see the transfer discipline below).
    shape_l = tuple(int(s) for s in lefts.shape[1:3])
    shape_r = (hr, wr)
    groups: dict = {}
    geo: List[Optional[tuple]] = [None] * b_total
    for b in range(b_total):
        if not ok[b]:
            continue
        (ch, cw), t_mat, (mx, my) = warp_ops.compute_canvas_geometry(
            hs[b], shape_l, shape_r
        )
        m = t_mat @ hs[b]
        m_inv = np.linalg.inv(m)
        pad_h = _r(ch, cfg.canvas_bucket)
        pad_w = _r(cw, cfg.canvas_bucket)
        wx0, wy0, win_w, win_h = warp_ops.warp_window_geometry(
            m, hr, wr, pad_h, pad_w, cfg.canvas_bucket
        )
        key = (pad_h, pad_w, win_h, win_w)
        geo[b] = (
            m_inv, warp_ops.left_offset(mx), warp_ops.left_offset(my),
            wx0, wy0, ch, cw,
        )
        groups.setdefault(key, []).append(b)

    out: List[Optional[np.ndarray]] = [None] * b_total
    for (pad_h, pad_w, win_h, win_w), idxs in groups.items():
        # Group doesn't divide the mesh: run it single-device. A per-group
        # LOCAL (not a `mesh = None` reassignment, which would silently
        # demote every LATER group too).
        g_mesh = (
            None
            if mesh is not None and len(idxs) % mesh.shape["data"] > 0
            else mesh
        )
        # Everything in the group body keeps host data on the HOST (numpy)
        # until ONE explicit device_put per operand, inside _mesh_scope so
        # even eager fallbacks stay on the mesh's devices.
        # tests/test_sharding.py runs this whole function under
        # jax.transfer_guard("disallow") to keep implicit transfers out.
        with _mesh_scope(mesh):
            canvases = _composite_group(
                lefts, rights, geo, idxs, b_total, g_mesh, mesh, cfg,
                pad_h, pad_w, win_h, win_w,
            )
        for row, b in enumerate(idxs):
            ch, cw = geo[b][5], geo[b][6]
            # copy(): a view would pin the whole group buffer in memory.
            out[b] = canvases[row, :ch, :cw].copy()
    return out


def _group_operands(lefts, rights, idxs, b_total, spec, mesh):
    """Gather one geometry group's image rows with NO implicit transfer.

    Full-range groups (the common throughput-mode case: every pair bucketed
    to the same canvas) reuse the batch arrays as-is. Partial groups gather
    device stacks with one jitted take per group (axis-0 row gather — not
    the CLAUDE.md flat-operand `jnp.take` compile trap) and host stacks with
    numpy. `spec` (a NamedSharding or None) commits the result explicitly;
    demoted groups (spec None, mesh set) collapse onto one mesh device so
    the single-device dispatch sees consistent placement.
    """
    full = list(idxs) == list(range(b_total))
    if isinstance(lefts, np.ndarray):
        gl = lefts if full else lefts[np.asarray(idxs)]
        gr = rights if full else rights[np.asarray(idxs)]
    elif full:
        gl, gr = lefts, rights
    else:
        idx_np = np.asarray(idxs, np.int32)
        # The tiny index vector is replicated over the batch arrays' mesh
        # EXPLICITLY — the partitioner would otherwise reshard it with an
        # implicit d2d copy (disallowed under the transfer discipline).
        idx = jax.device_put(
            idx_np,
            NamedSharding(mesh, P()) if mesh is not None else None,
        )
        gather = jax.jit(
            lambda a, b, i: (jnp.take(a, i, axis=0), jnp.take(b, i, axis=0))
        )
        gl, gr = gather(lefts, rights, idx)
    if spec is not None:
        return jax.device_put(gl, spec), jax.device_put(gr, spec)
    if mesh is not None:
        dev = next(iter(mesh.devices.flat))
        return jax.device_put(gl, dev), jax.device_put(gr, dev)
    return jax.device_put(gl), jax.device_put(gr)


def _composite_group(
    lefts, rights, geo, idxs, b_total, g_mesh, mesh, cfg,
    pad_h, pad_w, win_h, win_w,
):
    """One (canvas, window)-bucket group of composite_pairs_batched: a
    single vmapped warp+blend dispatch, sharded over 'data' when g_mesh is
    set. Returns the host uint8 canvases (len(idxs), pad_h, pad_w, 3)."""
    from pano.ops import warp as warp_ops

    sharded = g_mesh is not None and g_mesh.shape["data"] > 1
    spec = NamedSharding(g_mesh, P("data")) if sharded else None
    gl, gr = _group_operands(lefts, rights, idxs, b_total, spec, mesh)
    # Small per-pair vectors are assembled on the HOST and committed with
    # one explicit device_put each (see the caller's transfer discipline).
    gtx = np.asarray([geo[b][1] for b in idxs], np.int32)
    gty = np.asarray([geo[b][2] for b in idxs], np.int32)
    gwx = np.asarray([geo[b][3] for b in idxs], np.int32)
    gwy = np.asarray([geo[b][4] for b in idxs], np.int32)
    m_np = np.stack([geo[b][0] for b in idxs])

    def one(left, right, m_inv, tx, ty, wx, wy):
        return warp_ops.warp_and_blend(
            left, right, m_inv, tx, ty, pad_h, pad_w, cfg.blend,
            win_x=wx, win_y=wy, win_h=win_h, win_w=win_w,
            gain=cfg.gain_compensation,
        )

    fn = jax.vmap(one)
    if sharded:
        # The 3x3 maps and window origins are replicated (P()): they are
        # tiny, and the blend math reads each pair's row locally.
        rep = NamedSharding(g_mesh, P())
        small = tuple(
            jax.device_put(a, rep)
            for a in (m_np.astype(np.float32), gtx, gty, gwx, gwy)
        )
        fn = jax.jit(
            fn, in_shardings=(spec, spec) + (rep,) * 5,
        )
    else:
        small = tuple(
            jax.device_put(a)
            for a in (m_np.astype(np.float32), gtx, gty, gwx, gwy)
        )
        fn = jax.jit(fn)
    return pipeline._host_fetch(fn(gl, gr, *small))


def stitch_pairs_batched(
    lefts: jnp.ndarray,          # (B, H, W, 3) uint8 — same-shape pairs
    rights: jnp.ndarray,         # (B, H, W, 3) uint8
    config: PanoConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
) -> List[Optional[np.ndarray]]:
    """Throughput mode: stitch a batch of independent pairs.

    Homography estimation runs batched and sharded over the mesh's 'data'
    axis (estimate_homographies_batched); compositing runs batched per
    (canvas, window) size bucket (composite_pairs_batched) so both halves of
    the pipeline scale with device count. Returns a list of host uint8
    panoramas (None for failed pairs).
    """
    hs_d, counts_d, ok_d = estimate_homographies_batched(
        lefts, rights, config, mesh
    )
    b = int(lefts.shape[0])
    # Pack H + ok into ONE device array so the estimation half costs ONE
    # host fetch.
    packed = jnp.concatenate(
        [
            hs_d.reshape(b, 9).astype(jnp.float32),
            ok_d.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )
    v = pipeline._host_fetch(packed)
    hs = v[:, :9].astype(np.float64).reshape(b, 3, 3)
    ok = v[:, 9] > 0.5
    return composite_pairs_batched(lefts, rights, hs, ok, config, mesh)


# --------------------------------------------------------------------------
# Sharded matching (query rows over devices)
# --------------------------------------------------------------------------

def match_descriptors_sharded(
    desc_q: jnp.ndarray,
    valid_q: jnp.ndarray,
    desc_t: jnp.ndarray,
    valid_t: jnp.ndarray,
    max_ssd_thresh: float,
    mesh: Mesh,
    axis: str = "data",
    ratio_thresh: float = 0.0,
    cross_check: bool = False,
) -> match_ops.Matches:
    """Row-sharded brute-force matching: each device owns K/n query rows and
    the full train set; results concatenate along the query axis with no
    cross-device traffic (argmin is row-local).

    The Lowe ratio test is row-local too, so it shards exactly.
    `cross_check` is rejected: mutual-nearest-neighbor verification needs
    the train->query argmin over ALL query rows, but each shard sees only
    its own — a per-shard cross check would silently compute the wrong
    thing (it needs an argmin-reduce over the shard axis; use the local
    matcher when cross-checking)."""
    if cross_check:
        raise ValueError(
            "cross_check needs a global train->query argmin across query "
            "shards; unsupported in the row-sharded matcher"
        )
    n = mesh.shape[axis]
    if desc_q.shape[0] % n != 0:
        raise ValueError(f"query rows {desc_q.shape[0]} not divisible by {n}")

    def local(dq, vq, dt, vt):
        return match_ops.match_descriptors(
            dq, vq, dt, vt, max_ssd_thresh, ratio_thresh
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P()),
        out_specs=match_ops.Matches(P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)(desc_q, valid_q, desc_t, valid_t)


# --------------------------------------------------------------------------
# Sharded global composite (chain/auto compositing scales with the mesh)
# --------------------------------------------------------------------------

def warp_windows_batched(
    imgs: jnp.ndarray,        # (B, H, W, 3) uint8 — same-shape images
    m_invs: np.ndarray,       # (B, 3, 3) — inverse of T @ globals_h[i]
    origins: np.ndarray,      # (B, 2) — (wx0, wy0) window origins
    win_h: int,
    win_w: int,
    mesh: Optional[Mesh] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Warp a BATCH of images into their canvas windows in one dispatch,
    sharded over the 'data' mesh axis — the expensive half of global
    compositing (the bilinear gathers) scales with device count instead of
    looping on one device.

    Returns (packed RGB int32 (B, win_h, win_w), feather weight f32
    (B, win_h, win_w)) with the batch axis sharded over 'data'. The weight
    is the edge ramp resampled through the same map, quantized to u8 like
    warp_and_blend's feather branch."""
    from pano.ops import warp as warp_ops

    hr, wr = int(imgs.shape[1]), int(imgs.shape[2])

    def one(img, m_inv, orig):
        sx, sy = warp_ops._inverse_map(
            m_inv, win_h, win_w, orig[0], orig[1]
        )
        rgb_f, w_inb = warp_ops._bilinear_sample_u8(img, sx, sy)
        ramp = warp_ops._edge_ramp(hr, wr)
        wmap, _ = warp_ops._bilinear_sample_u8(
            (ramp[..., None] * 255.0).astype(jnp.uint8), sx, sy
        )
        w = (wmap[..., 0] / 255.0) * w_inb
        rgb_u8 = jnp.clip(jnp.round(rgb_f), 0, 255).astype(jnp.int32)
        packed = (
            rgb_u8[..., 0] | (rgb_u8[..., 1] << 8) | (rgb_u8[..., 2] << 16)
        )
        return packed, w

    m_invs = np.asarray(m_invs, np.float32)
    origins = np.asarray(origins, np.float32)
    fn = jax.vmap(one)
    with _mesh_scope(mesh):
        if mesh is not None and mesh.shape["data"] > 1:
            spec = NamedSharding(mesh, P("data"))
            imgs = jax.device_put(imgs, spec)
            m_invs = jax.device_put(m_invs, spec)
            origins = jax.device_put(origins, spec)
            fn = jax.jit(
                fn,
                in_shardings=(spec, spec, spec),
                out_shardings=(spec, spec),
            )
        else:
            imgs = jax.device_put(imgs)
            m_invs = jax.device_put(m_invs)
            origins = jax.device_put(origins)
            fn = jax.jit(fn)
        return fn(imgs, m_invs, origins)


@functools.lru_cache(maxsize=64)
def _global_blend_graphs(
    pad_h: int, pad_w: int, win_h: int, win_w: int,
    anchor_shape: tuple, blend: str, gain: bool,
):
    """Shape-memoized jitted (init, step) graphs for the sequential global
    blend (composite_global_sharded): init places the anchor image + its
    edge-ramp weight on zeroed canvases; step blends ONE warped window row
    against the accumulated (canvas, weight_canvas) — each is a single
    device dispatch instead of the ~6 eager launches the inline
    formulation paid (see call site). Memoization keys on every static
    the graphs close over, so repeated jobs re-trace nothing (the
    get_pair_stitcher pattern)."""
    from pano.ops import warp as warp_ops

    ah, aw = anchor_shape

    def init(anchor_img, t_org):
        ty0, tx0 = t_org[0], t_org[1]
        canvas = jnp.zeros((pad_h, pad_w, 3), jnp.uint8)
        canvas = jax.lax.dynamic_update_slice(
            canvas, anchor_img, (ty0, tx0, jnp.asarray(0, jnp.int32))
        )
        weight_canvas = jnp.zeros((pad_h, pad_w), jnp.float32)
        weight_canvas = jax.lax.dynamic_update_slice(
            weight_canvas, warp_ops._edge_ramp(ah, aw), (ty0, tx0)
        )
        return canvas, weight_canvas

    def step(canvas, weight_canvas, win_rgb, win_w_map, org):
        wy0, wx0 = org[0], org[1]
        zero = jnp.asarray(0, jnp.int32)
        w_left_win = jax.lax.dynamic_slice(
            weight_canvas, (wy0, wx0), (win_h, win_w)
        )
        canvas, new_w = warp_ops.blend_window_outputs(
            canvas, win_rgb, win_w_map, zero, zero, wx0, wy0,
            pad_h, pad_w, win_h, win_w, blend,
            w_left_win=w_left_win, gain=gain,
        )
        weight_canvas = jax.lax.dynamic_update_slice(
            weight_canvas, new_w, (wy0, wx0)
        )
        return canvas, weight_canvas

    return jax.jit(init), jax.jit(step)


def composite_global_sharded(
    images: List[np.ndarray],
    devs: List[jnp.ndarray],
    globals_h: List[Optional[np.ndarray]],
    config: PanoConfig,
    mesh: Optional[Mesh] = None,
    anchor: int = 0,
    _weights_out: Optional[list] = None,
) -> Optional[np.ndarray]:
    """Global composite with the per-image warps batched over the mesh.

    The warps (the expensive bilinear gathers) run as ONE vmapped dispatch
    sharded over 'data' (warp_windows_batched); the blend passes stay
    sequential (composition order is semantic — later images
    overwrite/blend over earlier ones, as in pipeline.composite_global).
    Blending consumes an accumulated weight canvas, so feather/multiband
    seams are placed against real coverage.

    `_weights_out` (tests only): a list that receives the final accumulated
    weight canvas, cropped to the true panorama.

    Heterogeneous image shapes fall back to the local composite."""
    cfg = config.stitch
    n = len(images)
    placed = [
        i for i in range(n) if i != anchor and globals_h[i] is not None
    ]
    if not placed or len({images[i].shape for i in placed}) != 1:
        return pipeline.composite_global(
            images, devs, globals_h, config, anchor
        )
    from pano.ops import warp as warp_ops

    t_mat, canvas_h, canvas_w, pad_h, pad_w = (
        pipeline.global_canvas_geometry(
            images, globals_h, anchor, cfg.canvas_bucket
        )
    )
    hr, wr = images[placed[0]].shape[:2]

    # Per-image window geometry; the batch needs ONE static window size, so
    # take the max bucket over the group and re-clamp each origin (the
    # enlarged window always still covers the original bbox).
    geos = []
    for i in placed:
        m = t_mat @ globals_h[i]
        m_inv = np.linalg.inv(m)
        wx0, wy0, win_w, win_h = warp_ops.warp_window_geometry(
            m, hr, wr, pad_h, pad_w, cfg.canvas_bucket
        )
        geos.append([m_inv, wx0, wy0, win_w, win_h])
    win_w_u = max(g[3] for g in geos)
    win_h_u = max(g[4] for g in geos)
    for g in geos:
        g[1] = min(g[1], pad_w - win_w_u)
        g[2] = min(g[2], pad_h - win_h_u)

    b = len(placed)
    n_data = mesh.shape["data"] if mesh is not None else 1
    pad_b = (-b) % n_data
    # _mesh_scope: every eager creation below (the image stack, canvas
    # zeros, scalar index constants) stays on the MESH's devices.
    with _mesh_scope(mesh):
        imgs = jnp.stack(
            [devs[i] for i in placed] + [devs[placed[-1]]] * pad_b
        )
        m_invs = np.stack(
            [g[0] for g in geos] + [geos[-1][0]] * pad_b
        )
        origins = np.array(
            [[g[1], g[2]] for g in geos]
            + [[geos[-1][1], geos[-1][2]]] * pad_b,
            np.float64,
        )
        wins, weights = warp_windows_batched(
            imgs, m_invs, origins, win_h_u, win_w_u, mesh
        )

        # Sequential blend (order is semantic); each pass consumes one
        # sharded window row and the accumulated weight canvas. The anchor
        # placement and each per-image pass run as ONE jitted dispatch
        # (shape-memoized via _global_blend_graphs).
        init, step = _global_blend_graphs(
            pad_h, pad_w, win_h_u, win_w_u, images[anchor].shape[:2],
            cfg.blend, cfg.gain_compensation,
        )
        t_org = jax.device_put(
            np.asarray([int(t_mat[1, 2]), int(t_mat[0, 2])], np.int32)
        )
        canvas, weight_canvas = init(devs[anchor], t_org)
        for k in range(b):
            org = jax.device_put(
                np.asarray([geos[k][2], geos[k][1]], np.int32)
            )
            canvas, weight_canvas = step(
                canvas, weight_canvas, wins[k], weights[k], org
            )
        if _weights_out is not None:
            _weights_out.append(
                np.asarray(weight_canvas[:canvas_h, :canvas_w])
            )
        return np.asarray(canvas[:canvas_h, :canvas_w])


# --------------------------------------------------------------------------
# Sharded fold (drop-in for pipeline.stitch_all_images)
# --------------------------------------------------------------------------

def stitch_all_images_chain_sharded(
    images: List[np.ndarray],
    config: PanoConfig = DEFAULT_CONFIG,
    timing_tag: str = "Sharded",
    mesh: Optional[Mesh] = None,
    print_timing: bool = True,
) -> Optional[np.ndarray]:
    """Chain-mode stitching with ALL adjacent-pair estimations in one
    sharded dispatch and ONE host fetch for the whole batch.

    The counterpart of the reference OpenMP path's total-time contract
    (src/openmp/main.cpp:563-606): n-1 fused estimate graphs become a single
    vmapped+sharded graph over the 'data' mesh axis, so the host pays one
    round trip regardless of image count. Homographies compose into
    the first image's frame; compositing runs the batched sharded warp path
    (composite_global_sharded) so it scales with the mesh like estimation.

    Heterogeneous image shapes can't batch — those fall back to the
    single-device chain (which still pipelines its dispatches).
    """

    t = Timer()
    n = len(images)
    if n == 0:
        return None
    if n < 2 or len({im.shape for im in images}) != 1:
        return pipeline.stitch_all_images_chain(
            images, config, print_timing=print_timing, timing_tag=timing_tag
        )
    if mesh is None:
        mesh = make_mesh(n_hyp=1)
    n_data = mesh.shape["data"]

    with _mesh_scope(mesh):  # eager stacks/slices stay on the mesh devices
        stack = jax.device_put(
            np.stack([np.asarray(im, np.uint8) for im in images])
        )
        lefts, rights = stack[:-1], stack[1:]
        b = n - 1
        pad = (-b) % n_data
        if pad:  # pad to the data-axis multiple; padded rows ignored
            lefts = jnp.concatenate([lefts, lefts[-1:].repeat(pad, axis=0)])
            rights = jnp.concatenate(
                [rights, rights[-1:].repeat(pad, axis=0)]
            )
        devs = [stack[i] for i in range(n)]

    packed_dev, pts = fused_estimate_batched(lefts, rights, config, mesh)
    v = pipeline._host_fetch(packed_dev)     # THE single batch host sync

    stitcher = pipeline.get_pair_stitcher(config, False)
    globals_h: List[Optional[np.ndarray]] = [np.eye(3)]
    last_good = 0
    for i in range(1, n):
        if print_timing:
            print(f"Stitching image {i + 1} of {n}...", flush=True)
        if last_good != i - 1:
            # Previous pair failed: re-anchor against the last chained image
            # (the fold's skip semantics, src/serial/main.cpp:404-407).
            h = stitcher.estimate_homography(devs[last_good], devs[i])
        else:
            # Shared fused-protocol decode (match-count bail, low-inlier
            # OpenCV fallback with lazily-fetched match points, best-effort
            # H) — pipeline.PairStitcher.interpret_fused_row.
            k = i - 1
            h = stitcher.interpret_fused_row(
                v[k],
                lambda k=k: (
                    np.asarray(pts[0][k]),
                    np.asarray(pts[1][k]),
                    np.asarray(pts[2][k]),
                ),
            )
        if h is None:
            print(f"Failed to stitch image {i}!", file=sys.stderr)
            globals_h.append(None)
            continue
        globals_h.append(globals_h[last_good] @ h)
        last_good = i

    result = composite_global_sharded(
        [np.asarray(im) for im in images], devs, globals_h, config,
        mesh=mesh, anchor=0,
    )
    if print_timing:
        print_stage(f"Total Stitching Process ({timing_tag})", t.elapsed())
    return result


def stitch_all_images_auto_sharded(
    images: List[np.ndarray],
    config: PanoConfig = DEFAULT_CONFIG,
    timing_tag: str = "Sharded",
    mesh: Optional[Mesh] = None,
    print_timing: bool = True,
    anchor: str = "auto",
) -> Optional[np.ndarray]:
    """Unordered stitching with the all-pairs estimation sharded: features
    are detected once per image, then ALL n(n-1)/2 pair estimates run as one
    vmapped dispatch with the pair axis sharded over the 'data' mesh axis —
    one host fetch for the whole match graph. The maximum-spanning-tree
    ordering reuses the pipeline implementation; compositing runs the
    batched sharded warp path (composite_global_sharded).

    Heterogeneous image shapes can't batch; those fall back to the
    single-device auto mode (whose per-pair dispatches are still pipelined).
    """
    t = Timer()
    n = len(images)
    if n == 0:
        return None
    if n < 3 or len({im.shape for im in images}) != 1:
        return pipeline.stitch_all_images_auto(
            images, config, print_timing=print_timing, timing_tag=timing_tag
        )
    if mesh is None:
        mesh = make_mesh(n_hyp=1)
    n_data = mesh.shape["data"]
    cfg_h, cfg_r = config.harris, config.ransac

    with _mesh_scope(mesh):  # eager placement pinned to the mesh devices
        devs = [
            jax.device_put(np.asarray(im, np.uint8)) for im in images
        ]

        # Detect + describe once per image (per-image dispatches, pipelined
        # by the async queue). The detect
        # graph is the config-memoized one the local auto mode shares
        # (pipeline.get_auto_graphs), so repeated jobs re-trace nothing.
        det, _ = pipeline.get_auto_graphs(config)
        feats = [det(d) for d in devs]
        xy = jnp.stack([f[0].xy for f in feats])       # (n, K, 2)
        desc = jnp.stack([f[1] for f in feats])        # (n, K, D)
        bv = jnp.stack([f[2] for f in feats])          # (n, K)

    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    p = len(pairs)
    pad = (-p) % n_data
    idx_i = np.asarray([a for a, _ in pairs] + [0] * pad, np.int32)
    idx_j = np.asarray([b for _, b in pairs] + [0] * pad, np.int32)

    def one_pair(i, j):
        # H maps j -> i (query = j, train = i), as in the local auto mode.
        kq = harris_ops.KeyPoints(
            xy=xy[j], response=jnp.zeros(xy.shape[1]), valid=bv[j]
        )
        kt = harris_ops.KeyPoints(
            xy=xy[i], response=jnp.zeros(xy.shape[1]), valid=bv[i]
        )
        m = match_ops.match_descriptors(
            desc[j], bv[j], desc[i], bv[i], cfg_h.max_ssd_thresh,
            ratio_thresh=cfg_h.ratio_thresh, cross_check=cfg_h.cross_check,
            block_size=cfg_h.match_block,
        )
        pq, pt, v = match_ops.gather_match_points(kq, kt, m)
        res = ransac_ops.ransac_homography(pq, pt, v, cfg_r)
        # Packed (11,) row [H.ravel(), inlier_count, ok]: ONE device array
        # for the whole graph => ONE host fetch, same protocol as the local
        # auto mode.
        return jnp.concatenate(
            [
                res.H.reshape(-1).astype(jnp.float32),
                jnp.stack(
                    [
                        res.inlier_count.astype(jnp.float32),
                        res.ok.astype(jnp.float32),
                    ]
                ),
            ]
        )

    fn = jax.vmap(one_pair)
    with _mesh_scope(mesh):
        if n_data > 1:
            spec = NamedSharding(mesh, P("data"))
            idx_i = jax.device_put(idx_i, spec)
            idx_j = jax.device_put(idx_j, spec)
            fn = jax.jit(fn, in_shardings=(spec, spec))
        else:
            idx_i = jax.device_put(idx_i)
            idx_j = jax.device_put(idx_j)
            fn = jax.jit(fn)
        packed = pipeline._host_fetch(fn(idx_i, idx_j))  # ONE fetch


    counts = np.zeros((n, n), np.int64)
    h_edge: dict = {}
    for k, (i, j) in enumerate(pairs):
        if packed[k, 10] <= 0.5:
            continue
        counts[i, j] = counts[j, i] = int(packed[k, 9])
        h_edge[(i, j)] = packed[k, :9].astype(np.float64).reshape(3, 3)

    if counts.sum() == 0:
        print("No connected image pairs!", file=sys.stderr)
        return None

    globals_h, root = pipeline.max_spanning_tree_globals(counts, h_edge, n, anchor)
    n_placed = sum(1 for g in globals_h if g is not None)
    print(
        f"Auto-ordering: root image {root + 1}, placed {n_placed} of {n}",
        flush=True,
    )
    globals_h = pipeline.maybe_refine_globals(
        globals_h, counts, h_edge, root, images, config
    )
    result = composite_global_sharded(
        [np.asarray(im) for im in images], devs, globals_h, config,
        mesh=mesh, anchor=root,
    )
    if print_timing:
        print_stage(f"Total Stitching Process ({timing_tag})", t.elapsed())
    return result


def stitch_all_images_sharded(
    images: List[np.ndarray],
    config: PanoConfig = DEFAULT_CONFIG,
    timing_tag: str = "Sharded",
    mesh: Optional[Mesh] = None,
    mode: str = "fold",
    anchor: str = "auto",
) -> Optional[np.ndarray]:
    """Sharded multi-image stitching.

    mode='chain' (recommended): one batched+sharded estimation dispatch for
    all adjacent pairs (stitch_all_images_chain_sharded).

    mode='fold': the reference's left-fold with RANSAC hypotheses sharded
    over all devices. The fold itself is sequential (each stitch depends on
    the previous panorama — the reference has the same serialization point,
    src/serial/main.cpp:395-414); within each pair, the hypothesis search
    runs across the mesh.

    mode='auto': unordered all-pairs ordering with the n(n-1)/2 pair
    estimates sharded over 'data' (stitch_all_images_auto_sharded).
    """
    from pano.pipeline import stitch_all_images

    if mode == "chain":
        return stitch_all_images_chain_sharded(
            images, config, timing_tag=timing_tag, mesh=mesh
        )
    if mode == "auto":
        return stitch_all_images_auto_sharded(
            images, config, timing_tag=timing_tag, mesh=mesh, anchor=anchor
        )

    n_dev = len(jax.devices())
    if n_dev <= 1 or len(images) < 2:
        return stitch_all_images(
            images, config, timing_tag=timing_tag
        )

    if mesh is None:
        mesh = make_mesh(n_data=1, n_hyp=n_dev)

    t = Timer()
    stitcher = _ShardedPairStitcher(mesh, config, timing_tag=timing_tag)
    panorama = jnp.asarray(images[0], jnp.uint8)
    n = len(images)
    for i in range(1, n):
        print(f"Stitching image {i + 1} of {n}...", flush=True)
        temp = stitcher.stitch_pair(panorama, jnp.asarray(images[i], jnp.uint8))
        if temp is None:
            print(f"Failed to stitch image {i}!", file=sys.stderr)
            continue
        panorama = temp
    print_stage(f"Total Stitching Process ({timing_tag})", t.elapsed())
    return np.asarray(panorama)


class _ShardedPairStitcher:
    """PairStitcher variant whose RANSAC shards hypotheses over the mesh."""

    def __init__(self, mesh: Mesh, config: PanoConfig, timing_tag: str = ""):
        self.mesh = mesh
        self.config = config
        self._inner = pipeline.get_pair_stitcher(config, True, timing_tag)
        n_hyp = mesh.shape["hyp"]
        r = config.ransac
        if r.num_iterations % n_hyp != 0:
            r = dataclasses.replace(
                r,
                num_iterations=((r.num_iterations + n_hyp - 1) // n_hyp)
                * n_hyp,
            )
        self._r_opts = r
        self._sharded_search = self._build_search()

    def _build_search(self):
        r = self._r_opts
        mesh = self.mesh
        iters_local = r.num_iterations // mesh.shape["hyp"]

        def spmd(pq, pt, v):
            hyp_idx = lax.axis_index("hyp")
            key = jax.random.fold_in(jax.random.PRNGKey(r.seed), hyp_idx)
            bh, bc = ransac_ops.ransac_best_hypothesis(
                key, pq, pt, v, iters_local, r.num_samples,
                r.distance_threshold,
            )
            all_h = lax.all_gather(bh, "hyp")
            all_c = lax.all_gather(bc, "hyp")
            win = jnp.argmax(all_c)
            return all_h[win], all_c[win]

        fn = jax.shard_map(
            spmd,
            mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )

        def search(pq, pt, v):
            bh, bc = fn(pq, pt, v)
            return ransac_ops.finalize_ransac(bh, bc, pq, pt, v, r)

        return jax.jit(search)

    def stitch_pair(self, left_dev, right_dev):
        t = Timer()
        s = self._inner
        kps_l = s.detect(left_dev)
        kps_r = s.detect(right_dev)
        matches = s.match(kps_r, kps_l, right_dev, left_dev)
        pq, pt, v = match_ops.gather_match_points(kps_r, kps_l, matches)
        if int(matches.count()) == 0:
            print("Not enough matched corners for stitching!", file=sys.stderr)
            return None

        t_r = Timer()
        res = self._sharded_search(pq, pt, v)
        jax.block_until_ready(res.H)
        if s.print_timing:
            print_stage(
                pipeline._suffix("RANSAC Homography Estimation", s.timing_tag),
                t_r.elapsed(),
            )

        # Same fallback ladder as the local paths (pipeline
        # interpret_fused_row): low-inlier gate -> OpenCV RANSAC on the
        # match points (src/gpu/ransac.cu:499-511), else best-effort H if
        # any inliers, else bail.
        if bool(res.ok):
            h = np.asarray(res.H, np.float64)
        else:
            h = s._opencv_fallback_h(
                np.asarray(pq), np.asarray(pt), np.asarray(v)
            )
            if h is None:
                if int(res.inlier_count) > 0:
                    h = np.asarray(res.H, np.float64)
                else:
                    print(
                        "RANSAC failed to estimate a homography matrix!",
                        file=sys.stderr,
                    )
                    return None
        canvas = s.composite(left_dev, right_dev, h)
        jax.block_until_ready(canvas)
        if s.print_timing:
            print_stage(
                pipeline._suffix("Image Stitching", s.timing_tag),
                t.elapsed(),
            )
        return canvas
