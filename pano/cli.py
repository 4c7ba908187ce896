"""Unified CLI — one entry point, multiple execution configs.

The reference builds four separate binaries (serial_stitching,
openmp_stitching, gpu_stitching, opencv_impl; pano.sh:36-57) that all accept
`[--dir D] [--out F] [img...]`. Here one module dispatches on the
implementation name:

  python -m pano.cli <impl> [--dir D] [--out F] [img...]

  serial  — the reference-semantics oracle on the JAX CPU backend
            (unsuffixed timing labels, like src/serial/main.cpp)
  gpu     — single-GPU path (the reference's gpu_stitching); fails when
            JAX sees no GPU (pano.device)
  sharded — multi-GPU batch/throughput path (pano.parallel)
  opencv  — cv::Stitcher quality baseline (src/opencv/main.cpp:37-95)

Exit codes and stdout/stderr lines match the reference mains
(src/serial/main.cpp:417-452): <2 images -> error + exit(-1); success prints
"Stitched result saved to <out>" and "Total Execution Time[ (tag)]: x ms".
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import List, Optional, Sequence

import numpy as np

from pano.config import DEFAULT_CONFIG, PanoConfig
from pano.io import imwrite_bgr, read_images_from_args
from pano.timer import Timer, print_stage

IMPL_ALIASES = {
    "tpu": "gpu",         # the accelerator impl's former name
    "openmp": "sharded",  # reference's multicore path -> our multi-GPU path
}
IMPLS = ("serial", "gpu", "sharded", "opencv")


def _opencv_stitch(images: List[np.ndarray]) -> Optional[np.ndarray]:
    """cv::Stitcher baseline with the reference's tuning
    (src/opencv/main.cpp:59-70): registration 0.6, seam 0.1, compositing 1.0,
    confidence 0.6, horizontal wave correction."""
    try:
        import cv2  # the cv::Stitcher baseline is OpenCV itself
    except ImportError:
        print("Error: the opencv implementation needs opencv-python (cv2), "
              "which is not installed", file=sys.stderr)
        return None

    stitcher = cv2.Stitcher.create(cv2.Stitcher_PANORAMA)
    # Python bindings expose a version-dependent subset of the C++ setters;
    # apply whatever this build supports (best effort, like the reference's
    # exact values where available).
    for setter, value in (
        ("setRegistrationResol", 0.6),
        ("setSeamEstimationResol", 0.1),
        ("setCompositingResol", 1.0),
        ("setPanoConfidenceThresh", 0.6),
        ("setWaveCorrection", True),
        ("setWaveCorrectKind", getattr(
            getattr(cv2, "detail", None), "WAVE_CORRECT_HORIZ", None
        )),
    ):
        fn = getattr(stitcher, setter, None)
        if fn is not None and value is not None:
            try:
                fn(value)
            except Exception:
                pass

    t = Timer()
    print("Creating stitcher and performing stitching...", flush=True)
    status, pano = stitcher.stitch(images)
    print_stage("Stitching process", t.elapsed())
    if status != cv2.Stitcher_OK:
        print(f"Stitching failed with status {status}", file=sys.stderr)
        return None
    return pano


@contextlib.contextmanager
def _maybe_profile():
    """JAX profiler trace when PANO_PROFILE=<dir> is set — the counterpart
    of the reference's `pano.sh perf` -> `perf record -g` wrapper
    (reference pano.sh:215-244). tools/xprof_summary.py reduces the
    xplane dump to per-op device time."""
    import os

    trace_dir = os.environ.get("PANO_PROFILE")
    if not trace_dir:
        yield
        return
    import jax

    print(f"Profiling to {trace_dir} (xplane)", flush=True)
    with jax.profiler.trace(trace_dir):
        yield


def _write_json_stats(path, impl, mode, config, output_file, panorama):
    """Machine-readable run stats (--json): the stdout timing contract plus
    config and result geometry, for tooling that shouldn't scrape stdout."""
    import dataclasses
    import json

    import jax

    from pano.timer import STAGE_RECORDS

    stats = {
        "impl": impl,
        "mode": mode,
        "backend": jax.default_backend(),
        "num_devices": len(jax.devices()),
        "config": {
            "harris": dataclasses.asdict(config.harris),
            "ransac": dataclasses.asdict(config.ransac),
            "stitch": dataclasses.asdict(config.stitch),
        },
        "stages": list(STAGE_RECORDS),
        "output_file": output_file,
        "panorama_shape": (
            list(panorama.shape) if panorama is not None else None
        ),
        "ok": panorama is not None,
    }
    with open(path, "w") as f:
        json.dump(stats, f, indent=2)
        f.write("\n")


def run(
    impl: str,
    argv: Sequence[str],
    config: PanoConfig = DEFAULT_CONFIG,
    _info: Optional[dict] = None,
    _preloaded: Optional[dict] = None,
    _encode_async=None,
) -> int:
    """`_info`, when given, is filled with facts about the run that only the
    flag-stripped reader knows (currently 'output_file') — the serve loop's
    status lines read it instead of re-parsing argv and diverging.
    `_preloaded` (serve's decode-ahead worker) maps image path -> decoded
    array; see io.read_images_from_args.
    `_encode_async` (serve's encode-behind): a submit(callable)->Future
    hook. When given, the output JPEG encode is submitted to it instead of
    running inline, the 'Stitched result saved to' line is DEFERRED to the
    caller (printed when the write completes), and the future is returned
    in _info['encode_future']. Otherwise the panorama encode sits on every
    warm serve job's critical path while the device idles."""
    import os

    from pano.timer import reset_stage_records

    reset_stage_records()
    total = Timer()
    impl = IMPL_ALIASES.get(impl, impl)
    if impl not in IMPLS:
        print(
            f"Unknown implementation: {impl}\n"
            f"Supported implementations: serial, gpu, sharded (openmp),"
            f" opencv",
            file=sys.stderr,
        )
        return -1

    # Extended flags (ours; stripped before the reference-parity reader).
    # Every HarrisCornerOptions/RansacOptions field is reachable — the
    # reference's mains set them all explicitly (src/serial/main.cpp:428-435)
    # but expose none on the command line; we expose the full surface:
    #   --mode fold|chain|auto         multi-image strategy
    #   --anchor auto|first            auto mode's root frame: best-connected
    #                                  image (robust default) or the first
    #                                  connected image (renders in chain
    #                                  mode's frame — the choice when grading
    #                                  against a reference panorama)
    #   --timing total|stages          total: fused single-sync product path
    #                                  (default for gpu/sharded); stages:
    #                                  per-stage timing lines, one host sync
    #                                  per stage (default for serial/parity)
    #   --blend overlay|feather|multiband   compositing (reference: overlay)
    #   --bundle auto|on|off           global frame refinement over the full
    #                                  validated pair graph (cv::Stitcher BA
    #                                  analog; auto = when the graph has
    #                                  redundant edges, ops/bundle.py)
    #   --k F --nms-thresh F --nms-size N --patch N --ssd-thresh F
    #                                  HarrisCornerOptions fields
    #   --kpts N                       static keypoint capacity (top-K)
    #   --ratio F (0=off) --cross-check on|off --topk exact|approx
    #   --topk-recall F                approx selection recall target
    #                                  matching robustness (additions over
    #                                  the reference)
    #   --iters N --dist F --seed N --refine on|off --min-inliers N
    #                                  RansacOptions fields
    #   --parity                       reference-semantics preset: raw argmin
    #                                  matching (no ratio/cross-check), exact
    #                                  top-K, overlay blend, fold mode
    #   --warmup                       one untimed run first (pays compiles)
    #   --json FILE                    machine-readable run stats (stages,
    #                                  config, output) in addition to stdout
    argv = list(argv)

    def take_flag(name, allowed=None):
        # Consume EVERY occurrence (last one wins, like argparse) so a
        # repeated flag never leaks into the image-path positionals.
        val = None
        while name in argv:
            i = argv.index(name)
            if i + 1 >= len(argv):
                print(f"Error: {name} requires a value", file=sys.stderr)
                raise SystemExit(-1)
            val = argv[i + 1]
            del argv[i : i + 2]
        if val is not None and allowed and val not in allowed:
            print(f"Unknown {name}: {val} ({'|'.join(allowed)})",
                  file=sys.stderr)
            raise SystemExit(-1)
        return val

    def take_switch(name):
        seen = False
        while name in argv:
            argv.remove(name)
            seen = True
        return seen

    _ONOFF = {"on": True, "off": False, "true": True, "false": False,
              "1": True, "0": False}

    warmup = take_switch("--warmup")
    parity = take_switch("--parity")
    timing = take_flag("--timing", ("total", "stages"))
    mode = take_flag("--mode", ("fold", "chain", "auto"))
    anchor = take_flag("--anchor", ("auto", "first")) or "auto"
    blend = take_flag("--blend", ("overlay", "feather", "multiband"))
    json_out = take_flag("--json")
    gain = take_flag("--gain", tuple(_ONOFF))
    bundle = take_flag("--bundle", ("auto", "on", "off"))

    harris_over = {}
    for flag, field, conv in (
        ("--k", "k", float),
        ("--nms-thresh", "nms_thresh", float),
        ("--nms-size", "nms_neighborhood", int),
        ("--patch", "patch_size", int),
        ("--ssd-thresh", "max_ssd_thresh", float),
        ("--kpts", "max_keypoints", int),
        ("--ratio", "ratio_thresh", float),
        ("--topk", "topk_method", str),
        ("--topk-recall", "topk_recall", float),
        ("--match-block", "match_block", int),
    ):
        v = take_flag(flag, ("exact", "approx") if field == "topk_method"
                      else None)
        if v is not None:
            harris_over[field] = conv(v)
    v = take_flag("--cross-check", tuple(_ONOFF))
    if v is not None:
        harris_over["cross_check"] = _ONOFF[v]

    ransac_over = {}
    for flag, field, conv in (
        ("--iters", "num_iterations", int),
        ("--dist", "distance_threshold", float),
        ("--seed", "seed", int),
        ("--min-inliers", "min_inliers", int),
    ):
        v = take_flag(flag)
        if v is not None:
            ransac_over[field] = conv(v)
    v = take_flag("--refine", tuple(_ONOFF))
    if v is not None:
        ransac_over["refine"] = _ONOFF[v]

    if parity:
        # Reference pipeline semantics end-to-end (raw argmin SSD matching
        # src/serial/main.cpp:188-244, exact selection, overlay blend
        # :380-386, left-fold :395-414, per-stage timing lines :182-302);
        # explicit flags still override.
        harris_over = {
            "ratio_thresh": 0.0, "cross_check": False,
            "topk_method": "exact", **harris_over,
        }
        blend = blend or "overlay"
        mode = mode or "fold"
        timing = timing or "stages"
    mode = mode or "fold"
    if timing is None:
        # The accelerator paths default to the PRODUCT (fused single-sync)
        # path — `pano.sh run gpu` must be as fast as bench.py, not pay a
        # host sync per stage line. The serial oracle keeps the reference's
        # per-stage contract by default; the reference's own default path
        # IS its fast path (src/gpu/main.cpp:322-449).
        timing = "stages" if impl in ("serial", "opencv") else "total"

    stitch_over = {}
    if blend:
        stitch_over["blend"] = blend
    if gain is not None:
        stitch_over["gain_compensation"] = _ONOFF[gain]
    if bundle is not None:
        stitch_over["bundle_adjust"] = bundle

    if harris_over or ransac_over or stitch_over:
        import dataclasses

        if harris_over:
            config = config.replace(
                harris=dataclasses.replace(config.harris, **harris_over)
            )
        if ransac_over:
            config = config.replace(
                ransac=dataclasses.replace(config.ransac, **ransac_over)
            )
        if stitch_over:
            config = config.replace(
                stitch=dataclasses.replace(config.stitch, **stitch_over)
            )

    # The OpenCV baseline times three phases — reading, stitching, saving —
    # with reference-exact labels (src/opencv/main.cpp:40-88).
    t_read = Timer()
    if impl == "opencv":
        print("Reading input images...", flush=True)
    reader = read_images_from_args(argv, preloaded=_preloaded)
    if _info is not None:
        _info["output_file"] = reader.output_file
    if impl == "opencv":
        print_stage("Reading input images", t_read.elapsed())
    if len(reader.images) < 2:
        print("At least two images are required for stitching!", file=sys.stderr)
        return -1

    tag = ""
    if impl == "opencv":
        print(f"Number of images loaded: {len(reader.images)}", flush=True)
        panorama = _opencv_stitch(reader.images)
        tag = "OpenCV"
    else:
        import jax

        from pano import device as device_mod
        from pano.pipeline import stitch_all_images

        if impl == "serial":
            # Pin the CPU platform before JAX initializes, so the serial
            # oracle never brings up a GPU backend (which would reserve
            # most of the card's memory for nothing).
            jax.config.update("jax_platforms", "cpu")
            device = jax.devices("cpu")[0]
            tag = ""
        elif impl == "gpu":
            device = device_mod.accelerator()
            tag = "GPU"
            print(f"JAX device: {device.device_kind}", flush=True)
            print(
                f"Number of Available Devices: "
                f"{len(device_mod.accelerators())}",
                flush=True,
            )
        elif impl == "sharded":
            from pano.parallel.shard import stitch_all_images_sharded

            tag = "Sharded"
            gpus = device_mod.accelerators()
            print(f"JAX device: {gpus[0].device_kind}", flush=True)
            print(f"Number of Available Devices: {len(gpus)}", flush=True)
            if warmup:
                stitch_all_images_sharded(
                    reader.images, config, timing_tag=tag, mode=mode,
                    anchor=anchor,
                )
                reset_stage_records()  # keep warmup out of --json stages
            with _maybe_profile():
                panorama = stitch_all_images_sharded(
                    reader.images, config, timing_tag=tag, mode=mode,
                    anchor=anchor,
                )

        if impl != "sharded":
            if warmup:
                # Same code path as the timed run (the staged/timed graphs
                # differ from the fused ones); benchmark parsers take the
                # LAST timing line, so the warmup's lines are harmless —
                # but keep them out of the --json stages list.
                stitch_all_images(
                    reader.images, config, timing_tag=tag, device=device,
                    mode=mode, timing=timing, anchor=anchor,
                )
                reset_stage_records()
            with _maybe_profile():
                panorama = stitch_all_images(
                    reader.images, config, timing_tag=tag, device=device,
                    mode=mode, timing=timing, anchor=anchor,
                )

    if panorama is None:
        print("Panoramic stitching failed!", file=sys.stderr)
        if json_out:
            _write_json_stats(
                json_out, impl, mode, config, reader.output_file, None
            )
        return -1

    t_save = Timer()
    if impl == "opencv":
        print("Saving panorama...", flush=True)
    if _encode_async is not None and impl != "opencv":
        # Encode-behind (serve): the JPEG write runs on the worker while
        # the NEXT job's device work is in flight; the caller prints the
        # 'saved' line + job status once the future resolves, keeping the
        # status-line contract (status == file durably written).
        out_file = reader.output_file
        pano_out = panorama

        def _encode():
            # imwrite returns False on codec/path failure without raising;
            # surface it so the drained status line reports 'failed'
            # instead of claiming a file that is not on disk.
            if not imwrite_bgr(out_file, pano_out):
                raise IOError(f"imwrite failed: {out_file}")

        fut = _encode_async(_encode)
        if _info is not None:
            _info["encode_future"] = fut
    else:
        imwrite_bgr(reader.output_file, panorama)
        if impl == "opencv":
            print_stage("Saving panorama", t_save.elapsed())
        print(f"Stitched result saved to {reader.output_file}", flush=True)
    print()
    label = f"Total Execution Time ({tag})" if tag else "Total Execution Time"
    print_stage(label, total.elapsed())
    if json_out:
        _write_json_stats(
            json_out, impl, mode, config, reader.output_file, panorama
        )
    return 0


def make_staging_decoder(push_dev, cache_cap: int):
    """Build serve's decode(+stage) worker function.

    Decodes each path with io.imread_bgr; when `push_dev` is a device, the
    decoded image is immediately staged device-side (jax.device_put) so
    the upload overlaps the previous job (serve's push-ahead). Successful
    results are kept in an LRU of `cache_cap` entries keyed by
    (realpath, mtime_ns, size) — repeated inputs skip decode AND upload;
    a rewritten file restages. Returns `decode(paths) -> {path: array|None}`
    (None = unreadable, read_images_from_args' skip contract)."""
    from collections import OrderedDict

    from pano.io import imread_bgr

    stage_cache: "OrderedDict[str, tuple]" = OrderedDict()

    def _decode(paths):
        out = {}
        for p in paths:
            key = os.path.realpath(p)
            try:
                st = os.stat(key)
                sig = (st.st_mtime_ns, st.st_size)
            except OSError:
                sig = None
            if sig is not None and key in stage_cache:
                csig, arr = stage_cache[key]
                if csig == sig:
                    stage_cache.move_to_end(key)
                    out[p] = arr
                    continue
                del stage_cache[key]  # file changed: restage
            img = imread_bgr(p)
            if img is not None and push_dev is not None:
                import jax

                img = jax.device_put(
                    np.ascontiguousarray(img, np.uint8), push_dev
                )
            if img is not None and sig is not None and cache_cap > 0:
                # Device arrays when staged, decoded host arrays otherwise
                # (CPU serves still skip the re-decode). Never mutated
                # downstream — the pipeline is functional end-to-end.
                stage_cache[key] = (sig, img)
                while len(stage_cache) > cache_cap:
                    stage_cache.popitem(last=False)
            out[p] = img
        return out

    return _decode


def serve(
    impl: str,
    argv: Sequence[str],
    config: PanoConfig = DEFAULT_CONFIG,
    stdin=None,
) -> int:
    """Persistent serving loop: ONE warm process, many stitch jobs.

    Every one-shot CLI invocation re-pays per-process costs — Python
    tracing of the fused graphs, compile-cache executable loading, device
    start-up — that can dwarf the device work of one pair. A serving process
    pays them once: jitted graphs are shared across jobs via
    pipeline.get_pair_stitcher and the module-level stage jits, so
    steady-state jobs run at device+I/O speed.

    Protocol (line-oriented, stdin -> stdout):
      * each input line is ONE job with exactly `run`'s argument surface
        (image paths, --dir, --out, and every extended flag — shlex rules);
      * the job's normal output (timing lines etc.) is printed, then a
        machine-readable status line:  `Job <n> <ok|failed> <out>: x.xxx ms`
      * a blank line is ignored; `quit` / `exit` / EOF end the loop (exit 0).
      * Status lines always appear in job order and `ok` always means the
        output file is durably on disk. With encode-behind (below), job
        n's 'Stitched result saved to' + status lines may print AFTER job
        n+1's timing lines (never after job n+1's status); when no further
        job is queued, ordering is exactly the classic per-job grouping.

    Default flags passed to `serve` itself (e.g. --mode chain) are prepended
    to every job line, so a fleet can pin a configuration at startup.
    The reference has no analog (each binary run is one-shot).

    Decode-ahead: when the next job line is already queued on stdin
    (fleet usage — jobs.txt or a pipe), its image decode runs on a worker
    thread WHILE the current job's device work is in flight, so
    steady-state jobs pay max(decode, rest) instead of decode + rest.
    Interactive stdin (no line queued yet) simply decodes inline.

    Push-ahead (gpu impl): the worker also STAGES the decoded images onto
    the device (jax.device_put) so the next job's upload overlaps the
    current job's compute and fetch. The pipeline passes an
    already-device-resident array through unchanged, so the job itself is
    byte-identical.

    Staging cache: staged device arrays are kept in a small LRU keyed by
    (realpath, mtime, size) — jobs that reuse an input image (parameter
    sweeps over one scene, sliding multi-image windows) skip its decode
    AND upload. Capacity PANO_SERVE_CACHE images (default 8 ≈ 300 MB of
    device memory at 13 MP; 0 disables); a re-encoded file (new mtime/size)
    restages.

    Encode-behind: the output image encode — the largest single-core chunk
    left on a warm job after decode-ahead — runs on its own worker while
    the NEXT job's device work is in flight; the
    job's 'saved' + status lines print once the write completes (see the
    protocol note above), so the status contract still means file-on-disk.
    """
    import os
    import queue
    import shlex
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from pano.io import imread_bgr

    # Push-ahead target: the gpu impl stages decoded images on its device
    # in the worker (see docstring); a missing GPU fails here, before any
    # job is read.
    push_dev = None
    if IMPL_ALIASES.get(impl, impl) == "gpu":
        from pano import device as device_mod

        push_dev = device_mod.accelerator()

    defaults = list(argv)
    stdin = sys.stdin if stdin is None else stdin
    print(
        f"pano serve ({impl}): one job per line, `run` argument surface;"
        " 'quit' or EOF ends",
        flush=True,
    )

    # Pump stdin on a thread so the loop can PEEK at the next job without
    # blocking the current one (None marks EOF).
    line_q: "queue.Queue" = queue.Queue()

    def _pump():
        try:
            for raw in stdin:
                line_q.put(raw)
        finally:
            line_q.put(None)

    threading.Thread(target=_pump, daemon=True).start()
    decode_pool = ThreadPoolExecutor(max_workers=1)
    # Encode-behind worker (separate from decode so a big decode never
    # queues behind a big encode): job n's output JPEG is written while job
    # n+1's device work is in flight. Job n's 'saved' + status lines print
    # when the write completes (after job n+1's stage lines at the latest —
    # status lines stay in job order and status still means 'file on
    # disk'). The codecs release the GIL, and the main thread mostly waits
    # on the device, so the overlap is real.
    encode_pool = ThreadPoolExecutor(max_workers=1)
    pending = None  # encode-behind slot: the previous job's deferred status

    def _drain():
        nonlocal pending
        if pending is None:
            return
        s, pending = pending, None
        status = "ok" if s["rc"] == 0 else "failed"
        if s["fut"] is not None:
            try:
                s["fut"].result()
                if s["rc"] == 0:
                    print(
                        f"Stitched result saved to {s['out']}", flush=True
                    )
            except Exception as e:
                print(f"job {s['n']} encode error: {e}", file=sys.stderr)
                status = "failed"
        print(
            f"Job {s['n']} {status} {s['out']}: {s['ms']:.3f} ms",
            flush=True,
        )

    # The flags `run` strips before its reader — the decode-ahead parser
    # must strip the same set or it would misread flag values as paths
    # (harmless — a stale cache entry is never looked up — but wasteful).
    value_flags = {
        "--timing", "--mode", "--anchor", "--blend", "--json", "--gain",
        "--bundle",
        "--k", "--nms-thresh", "--nms-size", "--patch", "--ssd-thresh",
        "--kpts", "--ratio", "--topk", "--topk-recall", "--match-block",
        "--cross-check",
        "--iters", "--dist", "--seed", "--min-inliers", "--refine",
        "--out",
    }
    switch_flags = {"--warmup", "--parity"}

    def _job_image_paths(args):
        """The image paths a job's reader will load (--dir expansion and
        positional rules of io.read_images_from_args), without loading."""
        paths, dir_name = [], None
        i = 0
        while i < len(args):
            a = args[i]
            if a == "--dir":
                dir_name = args[i + 1] if i + 1 < len(args) else None
                i += 2
            elif a in value_flags:
                i += 2
            elif a in switch_flags:
                i += 1
            else:
                paths.append(a)
                i += 1
        if dir_name:
            if not os.path.isdir(dir_name):
                return []
            return sorted(
                os.path.join(dir_name, e)
                for e in os.listdir(dir_name)
                if os.path.isfile(os.path.join(dir_name, e))
            )
        return paths

    try:
        cache_cap = int(os.environ.get("PANO_SERVE_CACHE", "8"))
    except ValueError:
        cache_cap = 8
    _decode = make_staging_decoder(push_dev, cache_cap)

    n = 0
    eof = False
    prefetched = None  # (stripped line, args or None, decode future or None)

    while True:
        if prefetched is not None:
            line, args, fut = prefetched
            prefetched = None
        else:
            if eof:
                break
            raw = line_q.get()
            if raw is None:
                break
            line, args, fut = raw.strip(), None, None
        if not line:
            continue
        if line in ("quit", "exit"):
            break
        n += 1
        t = Timer()
        if args is None:
            try:
                args = defaults + shlex.split(line)
            except ValueError as e:
                # Keep the status-line format machine-readable; detail to
                # stderr. Settle the previous job first so status lines
                # stay in job order.
                _drain()
                print(f"job {n} parse error: {e}", file=sys.stderr)
                print(f"Job {n} failed -: {t.elapsed():.3f} ms", flush=True)
                continue

        # Peek the next queued line and start ITS decode now, so it overlaps
        # this job's device work (a tiny timeout gives the pump thread time
        # to surface a line that is in flight on a fast pipe).
        if prefetched is None and not eof:
            try:
                raw_next = line_q.get(timeout=0.05)
            except queue.Empty:
                raw_next = False
            if raw_next is None:
                eof = True
            elif raw_next is not False:
                nl = raw_next.strip()
                nargs = nfut = None
                if nl and nl not in ("quit", "exit"):
                    try:
                        nargs = defaults + shlex.split(nl)
                        nfut = decode_pool.submit(
                            _decode, _job_image_paths(nargs)
                        )
                    except ValueError:
                        nargs = None  # its turn will report the parse error
                prefetched = (nl, nargs, nfut)

        pre = None
        if fut is not None:
            try:
                pre = fut.result()
            except Exception:
                pre = None  # decode-ahead failure: job decodes inline

        # run() fills _info with the output path ITS reader actually used
        # (after flag stripping) — serve must not re-parse and diverge.
        info: dict = {}
        try:
            rc = run(
                impl, args, config, _info=info, _preloaded=pre,
                _encode_async=encode_pool.submit,
            )
        except SystemExit as e:  # a bad job must not kill the server
            if isinstance(e.code, int) or e.code is None:
                rc = e.code or 0
            else:
                print(f"job {n} exit: {e.code}", file=sys.stderr)
                rc = -1
        except Exception as e:
            print(f"job {n} error: {e}", file=sys.stderr)
            rc = -1
        # Settle the PREVIOUS job (its encode overlapped this run), then
        # stash this one. The done-callback stamps the honest completion
        # time — when the write finished, not when we got around to
        # printing it.
        _drain()
        slot = {
            "n": n, "rc": rc, "out": info.get("output_file", "-"),
            "fut": info.get("encode_future"), "ms": t.elapsed(),
        }
        if slot["fut"] is not None:
            slot["fut"].add_done_callback(
                lambda f, tt=t, s=slot: s.__setitem__("ms", tt.elapsed())
            )
        pending = slot
        if prefetched is None:
            # Nothing queued: settle now so interactive callers see the
            # status immediately (identical ordering to pre-encode-behind).
            _drain()
    _drain()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    from pano.device import NoGPUError

    try:
        return _main(argv)
    except NoGPUError as e:
        print(f"Error: {e}", file=sys.stderr)
        return -1


def _main(argv: Optional[Sequence[str]]) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(
            "Usage: python -m pano.cli <serial|gpu|sharded|opencv> "
            "[--dir D] [--out F] [image1 image2 ...]\n"
            "       python -m pano.cli serve <impl> [default flags] "
            "< jobs.txt",
            file=sys.stderr,
        )
        return -1
    if argv[0] == "serve":
        if len(argv) < 2:
            print("Usage: python -m pano.cli serve <impl> "
                  "[default flags] < jobs.txt", file=sys.stderr)
            return -1
        return serve(argv[1], argv[2:])
    return run(argv[0], argv[1:])


if __name__ == "__main__":
    sys.exit(main())
