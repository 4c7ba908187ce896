#!/usr/bin/env python3
"""Smoke test of the stitcher on the GPU, through the entry points users call.

One process drives every phase on the first GPU at the repo's headline
size — a seeded pair of 4156x3117 BGR views (13 MP each), DEFAULT_CONFIG
(K = 8192 keypoints, 5x5 patches, 1000 RANSAC hypotheses, overlay blend)
and a 4-view chain at the same size:

  device  platform, device kind and count, JAX version, XLA_FLAGS, the
          compile-cache dir, the card's name and power limit
  ops     each device op against the plain numpy reference (pano.oracles)
  pair    `cli gpu` on the pair, graded against the scene's true geometry
  chain   `cli gpu --mode chain --blend multiband` on the 4 views
  serve   `cli serve gpu` answering 3 jobs
  trace   warm pair wall time, a traced steady window of pairs (device
          busy and idle share), per-stage device time, Harris with and
          without its optimization_barriers

Usage:
  python chip_smoke.py              all phases on one GPU
  python chip_smoke.py --rehearse   all phases on the CPU at 512x384
  python chip_smoke.py --chips 4    only the multi-GPU phase, on 4 GPUs
  python chip_smoke.py --chips 4 --rehearse   the same on 4 CPU devices

Any failed check raises and the process exits non-zero. The last line of
stdout is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import unittest.mock

HERE = os.path.dirname(os.path.abspath(__file__))

FULL = (3117, 4156)          # (height, width) of every view
REHEARSE = (384, 512)
# Scene seeds. At 512x384 a pair of seed 0 keeps RANSAC's 4-point
# hypothesis (its least-squares refit has one inlier fewer) at 3.5 px
# corner error, so the rehearsal uses a seed whose pairs all refine.
SEED = {"full": 0, "rehearse": 1}

# Tolerances, each with its reason.
RESP_REL = 1e-5      # Harris response vs float64: f32 sums in another order
KP_OVERLAP = 0.99    # exact top-K keypoint sets: borderline ranks may swap
CORNER_PX = 1.0      # estimated vs true H at the image corners: the
#                      reference evaluator's "Good" alignment grade
PSNR_DB = 25.0       # panorama vs the true render over warped regions
WARP_U8 = 1          # warp vs float64 bilinear: f32 coordinates move a
#                      sample by ~1e-3 px, enough to flip a rounding
AGREE_FRAC = 1e-3    # fused vs staged composite: share of pixels allowed
#                      beyond +-1 (f32 in-graph vs f64 host geometry can
#                      flip coverage on the warped border's one-px fringe)

# Trace phase: the untraced wall per pair comes from WALL_REPEATS windows of
# at least WALL_WINDOW_S each; the device idle share from one traced window
# of TRACE_PAIRS back-to-back pairs.
WALL_REPEATS = 5
WALL_WINDOW_S = {"full": 1.0, "rehearse": 0.2}
TRACE_PAIRS = {"full": 30, "rehearse": 3}
HARRIS_AB_REPS = 10   # warm calls per turn of the barrier A/B


class CheckFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    print(("  ok    " if ok else "  FAIL  ") + what, flush=True)
    if not ok:
        raise CheckFailed(what)


def phase(name: str):
    print(f"\n== {name} ==", flush=True)
    return time.perf_counter()


def card_lines() -> list:
    """nvidia-smi's name and power limit for every card (the child exits
    before we go on)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [l.strip() for l in r.stdout.splitlines() if l.strip()]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def device_phase(jax, want_platform: str, want_count: int):
    t = phase("device")
    devs = jax.devices()
    d0 = devs[0]
    print(f"  platform={d0.platform} kind={d0.device_kind} "
          f"count={len(devs)} jax={jax.__version__}")
    print(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"  compile cache={jax.config.jax_compilation_cache_dir}")
    if d0.platform != want_platform:
        print(f"Error: no GPU found: JAX's first device is {d0.platform!r}",
              file=sys.stderr)
        sys.exit(1)
    cards = card_lines() if want_platform == "gpu" else []
    for line in cards:
        print(f"  card: {line}")
    check(len(devs) >= want_count,
          f"{len(devs)} device(s) visible, need {want_count}")
    print(f"  [{time.perf_counter() - t:.1f} s]")
    return d0, devs, cards


def ops_phase(scene, dev):
    """Each device op at the real size against its float64 reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pano import oracles, scenes
    from pano.config import DEFAULT_CONFIG
    from pano.ops import harris, match, ransac, warp

    t = phase("ops")
    cfg = DEFAULT_CONFIG.harris
    h, w = scene.views[0].shape[:2]
    left = jax.device_put(scene.views[0], dev)
    right = jax.device_put(scene.views[1], dev)

    # Harris response, from the same integer gray plane on both sides.
    gray = jax.jit(harris.bgr_to_gray_f32)(left)
    resp = np.asarray(
        jax.jit(harris.harris_response, static_argnums=1)(gray, cfg.k)
    )
    want = oracles.harris_response(np.asarray(gray), cfg.k)
    rel = float(np.abs(resp - want).max() / np.abs(want).max())
    print(f"  harris response max |err| / max |R| = {rel:.3e}")
    check(rel <= RESP_REL, f"Harris response rel err <= {RESP_REL:g}")

    # Keypoints under exact top-K vs the oracle's NMS + top-K.
    exact = dataclasses.replace(cfg, topk_method="exact")
    detect = jax.jit(harris.harris_detect, static_argnums=1)
    kp_l = detect(left, exact)
    xy = np.asarray(kp_l.xy)[np.asarray(kp_l.valid)]
    oxy, _ = oracles.harris_peaks(want, cfg.nms_thresh, cfg.nms_neighborhood)
    oxy = oxy[: cfg.max_keypoints]
    got_set = {tuple(p) for p in xy.tolist()}
    want_set = {tuple(p) for p in oxy.tolist()}
    overlap = len(got_set & want_set) / max(len(want_set), 1)
    print(f"  keypoints: {len(got_set)} device / {len(want_set)} oracle, "
          f"overlap {overlap:.5f}")
    check(overlap >= KP_OVERLAP, f"exact top-K overlap >= {KP_OVERLAP}")

    # approx_max_k (the default selection) against the exact top-K.
    kp_a = detect(left, cfg)
    same = np.array_equal(np.asarray(kp_a.xy), np.asarray(kp_l.xy))
    a_set = {tuple(p) for p in
             np.asarray(kp_a.xy)[np.asarray(kp_a.valid)].tolist()}
    print(f"  approx_max_k(recall {cfg.topk_recall}) == top_k: {same} "
          f"(set overlap {len(a_set & got_set) / max(len(got_set), 1):.5f})")

    # Descriptor gather: bit-exact.
    kp_r = detect(right, exact)
    gather = jax.jit(match.extract_patch_descriptors, static_argnums=2)
    dl, bl = gather(left, kp_l, cfg.patch_size)
    dr, br = gather(right, kp_r, cfg.patch_size)
    ol, obl = oracles.patch_descriptors(
        scene.views[0], np.asarray(kp_l.xy), np.asarray(kp_l.valid),
        cfg.patch_size,
    )
    check(
        np.array_equal(np.asarray(dl), ol) and np.array_equal(
            np.asarray(bl), obl),
        f"descriptor gather bit-exact ({ol.shape[0]} x {ol.shape[1]})",
    )

    # SSD matcher at K = 8192: bit-exact index and SSD.
    m = jax.jit(
        match.match_descriptors, static_argnums=(4, 5, 6)
    )(dr, br, dl, bl, cfg.max_ssd_thresh, cfg.ratio_thresh, cfg.cross_check)
    oi, os_, ov = oracles.match_ssd(
        np.asarray(dr), np.asarray(br), np.asarray(dl), np.asarray(bl),
        cfg.max_ssd_thresh, cfg.ratio_thresh, cfg.cross_check,
    )
    gi, gs, gv = (np.asarray(a) for a in m)
    print(f"  matches: {int(gv.sum())} of K={len(gv)}")
    check(
        np.array_equal(gv, ov) and np.array_equal(gi, oi)
        and np.array_equal(gs.astype(np.float64), os_),
        "SSD matcher bit-exact (valid, index, SSD)",
    )

    # RANSAC on those matches.
    pq, pt, pv = match.gather_match_points(kp_r, kp_l, m)
    res = ransac.ransac_homography(pq, pt, pv, DEFAULT_CONFIG.ransac)
    h_est = np.asarray(res.H, np.float64)
    h_true = scenes.pair_homography(scene, 0, 1)
    err = scenes.corner_error(h_est, h_true, h, w)
    print(f"  RANSAC: {int(res.inlier_count)} inliers, corner error "
          f"{err:.4f} px")
    check(err <= CORNER_PX, f"RANSAC corner error <= {CORNER_PX} px")

    # Warp over the pair's true canvas.
    (ch, cw), t_mat, _ = warp.compute_canvas_geometry(h_true, (h, w), (h, w))
    m_inv = np.linalg.inv(t_mat @ h_true)
    got = np.asarray(
        jax.jit(warp.warp_perspective_u8, static_argnums=(2, 3))(
            right, jnp.asarray(m_inv, jnp.float32), ch, cw
        )
    )
    ref = oracles.warp_u8(scene.views[1], m_inv, ch, cw)
    dmax = int(np.abs(got.astype(int) - ref.astype(int)).max())
    print(f"  warp {ch}x{cw}: max |err| = {dmax}")
    check(dmax <= WARP_U8, f"warp within {WARP_U8} per u8 channel")
    print(f"  [{time.perf_counter() - t:.1f} s]")


def _echoed(fn, *args, **kwargs):
    """fn(*args, **kwargs) in this process with its stdout echoed; returns
    (result, captured stdout)."""
    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            return sys.__stdout__.write(s)

        def flush(self):
            sys.__stdout__.flush()

    with contextlib.redirect_stdout(Tee()):
        result = fn(*args, **kwargs)
    return result, buf.getvalue()


def _run_cli(argv):
    """pano.cli main in this process: (exit code, its stdout)."""
    from pano import cli

    return _echoed(cli.main, argv)


def _pair_truth(scene, i, j, pano, h_est):
    """Corner error of h_est and PSNR of a pair panorama over the warped
    view's interior, against the true render in the same frame."""
    from pano import scenes
    from pano.ops import warp

    h, w = scene.views[i].shape[:2]
    err = scenes.corner_error(h_est, scenes.pair_homography(scene, i, j),
                              h, w)
    (ch, cw), t_mat, _ = warp.compute_canvas_geometry(h_est, (h, w), (h, w))
    truth = scenes.truth_canvas(scene, i, t_mat, ch, cw)
    region = scenes.footprint(
        t_mat @ scenes.pair_homography(scene, i, j), h, w, ch, cw
    )
    shape_ok = pano is not None and pano.shape == (ch, cw, 3)
    db = scenes.psnr(pano, truth, region) if shape_ok else float("nan")
    return err, shape_ok, db


def pair_phase(scene, tmp, dev, paths):
    import jax
    import numpy as np

    from pano.config import DEFAULT_CONFIG
    from pano.io import imread_bgr
    from pano.pipeline import PairStitcher

    t = phase("pair")
    out = os.path.join(tmp, "pair.png")
    rc, _ = _run_cli(["gpu", paths[0], paths[1], "--out", out])
    check(rc == 0, "cli gpu exit code 0")
    pano = imread_bgr(out)

    stitcher = PairStitcher(DEFAULT_CONFIG, print_timing=False)
    left = jax.device_put(scene.views[0], dev)
    right = jax.device_put(scene.views[1], dev)
    row, _ = stitcher._fused_estimate(left, right)
    h_est = np.asarray(row)[:9].reshape(3, 3).astype(np.float64)
    err, shape_ok, db = _pair_truth(scene, 0, 1, pano, h_est)
    print(f"  panorama {None if pano is None else pano.shape}, corner "
          f"error {err:.4f} px, PSNR {db:.2f} dB")
    check(err <= CORNER_PX, f"pair corner error <= {CORNER_PX} px")
    check(shape_ok, "panorama has the estimated canvas size")
    check(db >= PSNR_DB, f"pair PSNR >= {PSNR_DB} dB")

    fused = np.asarray(stitcher.stitch_pair_fast(left, right))
    staged = np.asarray(stitcher.composite(left, right, h_est))
    same_shape = fused.shape == staged.shape
    d = np.abs(fused.astype(int) - staged.astype(int)) if same_shape else None
    frac = float((d > 1).mean()) if same_shape else 1.0
    print(f"  fused vs staged composite: shapes {fused.shape} "
          f"{staged.shape}, share beyond +-1 = {frac:.2e}, max "
          f"{None if d is None else int(d.max())}")
    check(same_shape and frac <= AGREE_FRAC,
          f"fused and staged agree within +-1 (<= {AGREE_FRAC:g} outside)")
    check(np.array_equal(fused, pano), "cli output == stitch_pair_fast")

    print("  warm --timing stages lines:")
    rc, _ = _run_cli(["gpu", paths[0], paths[1], "--out",
                      os.path.join(tmp, "staged.png"),
                      "--timing", "stages", "--warmup"])
    check(rc == 0, "cli gpu --timing stages exit code 0")
    print(f"  [{time.perf_counter() - t:.1f} s]")
    return stitcher, left, right


def chain_phase(scene, tmp, dev, view_dir, blend="multiband", impl="gpu"):
    import jax
    import numpy as np

    from pano import pipeline, scenes
    from pano.config import DEFAULT_CONFIG
    from pano.io import imread_bgr

    t = phase(f"chain ({impl}, {blend})")
    out = os.path.join(tmp, f"chain_{impl}.png")
    rc, _ = _run_cli([impl, "--dir", view_dir, "--mode", "chain",
                      "--blend", blend, "--out", out])
    check(rc == 0, f"cli {impl} --mode chain exit code 0")
    pano = imread_bgr(out)

    n = len(scene.views)
    h, w = scene.views[0].shape[:2]
    stitcher = pipeline.get_pair_stitcher(DEFAULT_CONFIG, False, "")
    devs = [jax.device_put(v, dev) for v in scene.views]
    globals_h = [np.eye(3)]
    for i in range(1, n):
        row, _ = stitcher._fused_estimate(devs[i - 1], devs[i])
        h_est = np.asarray(row)[:9].reshape(3, 3).astype(np.float64)
        err = scenes.corner_error(
            h_est, scenes.pair_homography(scene, i - 1, i), h, w
        )
        print(f"  pair {i - 1}-{i}: corner error {err:.4f} px")
        check(err <= CORNER_PX, f"chain pair {i - 1}-{i} corner error "
              f"<= {CORNER_PX} px")
        globals_h.append(globals_h[-1] @ h_est)
    t_mat, ch, cw, _, _ = pipeline.global_canvas_geometry(
        scene.views, globals_h, 0, DEFAULT_CONFIG.stitch.canvas_bucket
    )
    check(pano is not None and pano.shape == (ch, cw, 3),
          f"chain panorama {None if pano is None else pano.shape} has the "
          f"estimated canvas size ({ch}, {cw})")
    truth = scenes.truth_canvas(scene, 0, t_mat, ch, cw)
    # Warped views only: the anchor lands at an integer offset
    # (src/serial/main.cpp:376), a sub-pixel shift from the true frame.
    region = np.zeros((ch, cw), bool)
    for i in range(1, n):
        region |= scenes.footprint(
            t_mat @ scenes.pair_homography(scene, 0, i), h, w, ch, cw
        )
    region &= ~scenes.footprint(t_mat, h, w, ch, cw, erode=-2)
    db = scenes.psnr(pano, truth, region)
    print(f"  chain PSNR over warped views {db:.2f} dB")
    check(db >= PSNR_DB, f"chain PSNR >= {PSNR_DB} dB")
    print(f"  [{time.perf_counter() - t:.1f} s]")
    return pano


def serve_phase(scene, tmp, view_paths):
    import jax
    import numpy as np

    from pano import cli
    from pano.config import DEFAULT_CONFIG
    from pano.io import imread_bgr
    from pano.pipeline import get_pair_stitcher

    t = phase("serve")

    jobs, outs = [], []
    for k in range(3):
        out = os.path.join(tmp, f"serve_{k}.png")
        outs.append(out)
        jobs.append(f"{view_paths[k]} {view_paths[k + 1]} --out {out}\n")
    rc, text = _echoed(cli.serve, "gpu", [],
                       stdin=io.StringIO("".join(jobs)))
    check(rc == 0, "cli serve gpu exit code 0")
    stitcher = get_pair_stitcher(DEFAULT_CONFIG, False, "")
    for k in range(3):
        check(f"Job {k + 1} ok {outs[k]}:" in text, f"job {k + 1} ok")
        row, _ = stitcher._fused_estimate(
            jax.numpy.asarray(scene.views[k]),
            jax.numpy.asarray(scene.views[k + 1]),
        )
        h_est = np.asarray(row)[:9].reshape(3, 3).astype(np.float64)
        err, shape_ok, db = _pair_truth(
            scene, k, k + 1, imread_bgr(outs[k]), h_est
        )
        print(f"  job {k + 1}: corner error {err:.4f} px, PSNR {db:.2f} dB")
        check(shape_ok and err <= CORNER_PX and db >= PSNR_DB,
              f"job {k + 1} output checks")
    print(f"  [{time.perf_counter() - t:.1f} s]")


def trace_phase(stitcher, left, right, tmp, mode):
    import jax
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import xprof_summary

    t = phase("trace")
    jax.block_until_ready(stitcher.stitch_pair_fast(left, right))  # warm

    # Wall time per pair with the profiler off, over several windows.
    per_pair = []
    for _ in range(WALL_REPEATS):
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < WALL_WINDOW_S[mode]:
            pano = stitcher.stitch_pair_fast(left, right)
            n += 1
        jax.block_until_ready(pano)
        per_pair.append((time.perf_counter() - t0) * 1e3 / n)
    runs = ", ".join(f"{v:.3f}" for v in per_pair)
    print(f"  untraced wall per warm pair, {WALL_REPEATS} windows of >= "
          f"{WALL_WINDOW_S[mode]} s: median {np.median(per_pair):.3f} ms, "
          f"min {min(per_pair):.3f}, max {max(per_pair):.3f} (runs: {runs})")

    # One traced steady window of back-to-back pairs: busy is the union of
    # the device ops inside the window's host span, idle share 1 - busy /
    # window. The profiler slows the host, so this idle share is an upper
    # bound on the untraced one.
    reps = TRACE_PAIRS[mode]
    tdir = os.path.join(tmp, "trace")
    with jax.profiler.trace(tdir):
        with jax.profiler.TraceAnnotation("steady_window"):
            for _ in range(reps):
                pano = stitcher.stitch_pair_fast(left, right)
            jax.block_until_ready(pano)
    pd = xprof_summary.load(xprof_summary.find_pb(tdir))
    w0, w1 = xprof_summary.host_span_ns(pd, "steady_window")
    window = (w1 - w0) / 1e6
    if left.devices().pop().platform == "cpu":
        # The CPU backend writes no device plane: only the host planes.
        check(any(xprof_summary.plane_busy_ns(p) > 0 for p in pd.planes),
              "trace holds events (CPU rehearsal: host planes only)")
    else:
        check(bool(xprof_summary.device_planes(pd))
              and xprof_summary.device_busy_ms(pd) > 0,
              "trace holds device ops")
    print(f"  traced window of {reps} warm pairs: {window:.3f} ms "
          f"({window / reps:.3f} ms per pair)")
    if xprof_summary.device_planes(pd):
        busy = xprof_summary.device_busy_in_ms(pd, w0, w1)
        print(f"  device busy in the window {busy:.3f} ms ({busy / reps:.3f} "
              f"ms per pair; {xprof_summary.device_busy_ms(pd):.3f} ms in "
              f"the whole trace), idle share {1 - busy / window:.4f}")
    else:
        print("  device busy and idle share: not measured (no device plane)")
    xprof_summary.summarize(pd, top=25)
    _stage_times(stitcher, left, right, tmp, xprof_summary)
    print(f"  [{time.perf_counter() - t:.1f} s]")


def _traced_ms(fn, args, reps, tdir, xprof_summary):
    """Device busy per call over `reps` warm calls of fn, and the trace."""
    import jax

    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(tdir):
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
    pd = xprof_summary.load(xprof_summary.find_pb(tdir))
    return xprof_summary.device_busy_ms(pd) / reps, pd


def _stage_times(stitcher, left, right, tmp, xprof_summary, reps=3):
    """Device time per call of each stage's own XLA program on the pair,
    each from a profiler trace of `reps` warm calls, with its top ops; then
    Harris with and without its optimization_barriers."""
    import jax
    import numpy as np

    from pano.ops import harris, match, ransac

    cfg = stitcher.config
    hc = cfg.harris
    detect = jax.jit(harris.harris_detect, static_argnums=1)
    gather = jax.jit(match.extract_patch_descriptors, static_argnums=2)
    matcher = jax.jit(match.match_descriptors, static_argnums=(4, 5, 6))
    kl, kr = detect(left, hc), detect(right, hc)
    dl, bl = gather(left, kl, hc.patch_size)
    dr, br = gather(right, kr, hc.patch_size)
    m = matcher(dr, br, dl, bl, hc.max_ssd_thresh, hc.ratio_thresh,
                hc.cross_check)
    pts = jax.jit(match.gather_match_points)(kr, kl, m)
    est, _ = stitcher._fused_estimate(left, right)
    stages = [
        ("harris_detect (one view)", detect, (left, hc)),
        ("patch descriptors (one view)", gather, (left, kl, hc.patch_size)),
        ("ssd_match", matcher, (dr, br, dl, bl, hc.max_ssd_thresh,
                                hc.ratio_thresh, hc.cross_check)),
        ("ransac_homography", ransac.ransac_homography,
         (*pts, cfg.ransac)),
        ("fused compose (warp+overlay)", stitcher._fused_compose(0),
         (left, right, est)),
    ]
    print(f"  per-stage device time ({reps} warm calls each, own trace):")
    for k, (name, fn, args) in enumerate(stages):
        ms, pd = _traced_ms(fn, args, reps, os.path.join(tmp, f"stage_{k}"),
                            xprof_summary)
        print(f"    {name:<30} {ms:9.3f} ms/call")
        for plane in xprof_summary.device_planes(pd):
            rows = sorted(xprof_summary.op_table(plane).items(),
                          key=lambda kv: -kv[1][0])[:6]
            for op, (ns, n) in rows:
                print(f"      {op[:60]:<60} {ns / 1e6 / reps:8.3f} ms/call"
                      f"  x{n // reps}")

    # The barriers in ops/conv.py and ops/harris.py stop XLA from fusing
    # the gradient taps into every product. A separate jit traced with
    # lax.optimization_barrier as the identity gives the program without
    # them; the two are timed in turns (with, without, without, with).
    bare = jax.jit(lambda img, o: harris.harris_detect(img, o),
                   static_argnums=1)
    with unittest.mock.patch.object(jax.lax, "optimization_barrier",
                                    lambda x: x):
        kp_bare = bare(left, hc)
    check(np.array_equal(np.asarray(kp_bare.xy), np.asarray(kl.xy))
          and np.array_equal(np.asarray(kp_bare.valid), np.asarray(kl.valid)),
          "Harris keypoints equal with and without the barriers")
    times = {"with": [], "without": []}
    for k, key in enumerate(("with", "without", "without", "with")):
        fn = detect if key == "with" else bare
        ms, _ = _traced_ms(fn, (left, hc), HARRIS_AB_REPS,
                           os.path.join(tmp, f"harris_ab_{k}"), xprof_summary)
        times[key].append(ms)
    for key, ms in times.items():
        print(f"  harris_detect (one view) {key} barriers: "
              f"{np.mean(ms):.3f} ms/call (turns: "
              f"{', '.join(f'{v:.3f}' for v in ms)}; {HARRIS_AB_REPS} "
              "warm calls each)")


def multi_gpu_phase(devs, size, seed, tmp):
    """Four cards: stitch_pairs_batched over a (4 data x 1 hyp) mesh vs the
    single-card stitch_pair_fast, then `cli sharded --mode chain` vs the
    single-card chain."""
    import jax
    import numpy as np

    from pano import scenes
    from pano.config import DEFAULT_CONFIG
    from pano.io import imread_bgr
    from pano.parallel import shard
    from pano.pipeline import PairStitcher

    t = phase("multi-GPU pairs")
    h, w = size
    pairs = [scenes.make_scene(2, h, w, seed + k) for k in range(1, 5)]
    lefts = np.stack([s.views[0] for s in pairs])
    rights = np.stack([s.views[1] for s in pairs])
    mesh = shard.make_mesh(n_data=4, n_hyp=1)
    check(set(mesh.devices.flat) == set(devs[:4]), "mesh spans 4 devices")
    batched = shard.stitch_pairs_batched(lefts, rights, DEFAULT_CONFIG, mesh)
    single = PairStitcher(DEFAULT_CONFIG, print_timing=False)
    for k, sc in enumerate(pairs):
        l0 = jax.device_put(sc.views[0], devs[0])
        r0 = jax.device_put(sc.views[1], devs[0])
        ref = np.asarray(single.stitch_pair_fast(l0, r0))
        got = batched[k]
        same = got is not None and got.shape == ref.shape
        db = scenes.psnr(got, ref) if same else float("nan")
        print(f"  pair {k}: batched {None if got is None else got.shape} "
              f"vs single {ref.shape}, PSNR between them {db:.2f} dB")
        check(same and db >= 30.0, f"pair {k} batched == single-card")
    print(f"  [{time.perf_counter() - t:.1f} s]")

    t = phase("multi-GPU chain")
    chain = scenes.make_scene(4, h, w, seed)
    view_dir = os.path.join(tmp, "chain4")
    scenes.write_views(chain, view_dir)
    sharded = chain_phase(chain, tmp, devs[0], view_dir, "overlay",
                          "sharded")
    local = chain_phase(chain, tmp, devs[0], view_dir, "overlay", "gpu")
    check(sharded.shape == local.shape, "sharded and single-card chain "
          "panoramas have one shape")
    d = np.abs(sharded.astype(int) - local.astype(int))
    frac = float((d > 2).mean())
    print(f"  sharded vs single-card chain: share beyond +-2 = {frac:.2e}")
    check(frac <= AGREE_FRAC, "sharded chain == single-card chain")
    for d_ in devs[:4]:
        stats = d_.memory_stats()
        if stats is None:  # the CPU backend keeps no allocator stats
            print(f"  {d_}: peak_bytes_in_use not available")
            continue
        peak = stats["peak_bytes_in_use"]
        print(f"  {d_}: peak_bytes_in_use {peak}")
        check(peak > 0, f"{d_} was used")
    print(f"  [{time.perf_counter() - t:.1f} s]")


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at 512x384 (an explicit choice, "
                    "never a fallback)")
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-GPU phase")
    args = ap.parse_args(argv)

    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.chips == 4:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4"
            ).strip()
    sys.path.insert(0, HERE)
    import jax

    import pano  # noqa: F401  (fails outside a checkout of the repo)
    from pano import device, scenes

    if args.rehearse:
        # The accelerator impls run on the CPU devices, by this explicit
        # choice only (pano.device never falls back on its own).
        device.accelerators = lambda: jax.devices("cpu")
        device.accelerator = lambda: jax.devices("cpu")[0]

    platform = "cpu" if args.rehearse else "gpu"
    dev, devs, cards = device_phase(jax, platform, args.chips)
    mode = "rehearse" if args.rehearse else "full"
    size = REHEARSE if args.rehearse else FULL
    seed = SEED[mode]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.chips == 4:
            multi_gpu_phase(devs, size, seed, tmp)
        else:
            t = time.perf_counter()
            chain = scenes.make_scene(4, size[0], size[1], seed)
            view_dir = os.path.join(tmp, "chain")
            paths = scenes.write_views(chain, view_dir)
            print(f"\nscene: 4 views {size[1]}x{size[0]}, seed {seed} "
                  f"[{time.perf_counter() - t:.1f} s]")
            ops_phase(chain, dev)
            stitcher, left, right = pair_phase(chain, tmp, dev, paths)
            chain_phase(chain, tmp, dev, view_dir)
            serve_phase(chain, tmp, paths)
            trace_phase(stitcher, left, right, tmp, mode)

    for line in cards:
        print(line)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devs)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
