"""CLI tests: dispatch, exit codes, flag parsing, --parity preset, --json.

Reference semantics covered: unknown impl / <2 images exit(-1) with the
reference's messages (src/serial/main.cpp:417-452, src/reader/reader.cpp),
the full hyperparameter flag surface, and the machine-readable stats file.
"""

import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from pano import cli


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """Two small overlapping textured images on disk."""
    d = tmp_path_factory.mktemp("cli_imgs")
    r = np.random.default_rng(0)
    base = np.full((96, 192, 3), 30, np.uint8)
    for _ in range(120):
        y, x = r.integers(4, 88), r.integers(4, 184)
        base[y : y + 6, x : x + 6] = r.integers(60, 255, 3)
    cv2.imwrite(str(d / "a1.png"), base[:, :128])
    cv2.imwrite(str(d / "a2.png"), base[:, 64:])
    return str(d)


def test_unknown_impl_exits_minus_one(capsys):
    assert cli.run("vulkan", []) == -1
    assert "Unknown implementation" in capsys.readouterr().err


def test_fewer_than_two_images_exits_minus_one(scene_dir, capsys):
    rc = cli.run("serial", [os.path.join(scene_dir, "a1.png")])
    assert rc == -1
    assert "At least two images" in capsys.readouterr().err


def test_flag_requires_value():
    with pytest.raises(SystemExit):
        cli.run("serial", ["--mode"])


def test_bad_enum_value_rejected():
    with pytest.raises(SystemExit):
        cli.run("serial", ["--mode", "spiral", "x.jpg", "y.jpg"])
    with pytest.raises(SystemExit):
        cli.run("serial", ["--blend", "gradient", "x.jpg", "y.jpg"])
    with pytest.raises(SystemExit):
        cli.run("serial", ["--topk", "sorta", "x.jpg", "y.jpg"])
    with pytest.raises(ValueError):  # config validation, not argparse
        cli.run("serial", ["--topk-recall", "1.5", "x.jpg", "y.jpg"])


def test_repeated_flag_last_wins(scene_dir, tmp_path):
    """A repeated flag must not leak into the image-path positionals;
    the last occurrence wins (argparse semantics)."""
    out = str(tmp_path / "pano.jpg")
    stats = str(tmp_path / "stats.json")
    rc = cli.run(
        "serial",
        [
            "--dir", scene_dir, "--out", out,
            "--mode", "fold", "--mode", "chain",
            "--json", stats,
        ],
    )
    assert rc == 0
    assert json.load(open(stats))["mode"] == "chain"


def test_end_to_end_serial_with_full_flag_surface(scene_dir, tmp_path):
    """A real run exercising the whole hyperparameter surface + --json."""
    out = str(tmp_path / "pano.jpg")
    stats = str(tmp_path / "stats.json")
    rc = cli.run(
        "serial",
        [
            "--dir", scene_dir, "--out", out,
            "--mode", "chain", "--blend", "feather",
            "--k", "0.05", "--nms-thresh", "5e5", "--nms-size", "3",
            "--patch", "5", "--ssd-thresh", "1e9", "--kpts", "256",
            "--ratio", "0.9", "--cross-check", "on", "--topk", "exact",
            "--topk-recall", "0.9", "--match-block", "64",
            "--iters", "128", "--dist", "2.0", "--seed", "3",
            "--refine", "on", "--min-inliers", "8",
            "--json", stats,
        ],
    )
    assert rc == 0
    assert os.path.exists(out)
    s = json.load(open(stats))
    assert s["ok"] and s["impl"] == "serial" and s["mode"] == "chain"
    h, r = s["config"]["harris"], s["config"]["ransac"]
    assert h["k"] == 0.05 and h["max_keypoints"] == 256
    assert h["ratio_thresh"] == 0.9 and h["topk_method"] == "exact"
    assert h["topk_recall"] == 0.9
    assert h["match_block"] == 64 and h["cross_check"] is True
    assert r["num_iterations"] == 128 and r["seed"] == 3
    assert r["distance_threshold"] == 2.0 and r["min_inliers"] == 8
    assert s["config"]["stitch"]["blend"] == "feather"
    assert any("Total" in rec["stage"] for rec in s["stages"])
    pano = cv2.imread(out)
    assert pano is not None and pano.shape[1] >= 180


def test_parity_preset_sets_reference_semantics(scene_dir, tmp_path):
    out = str(tmp_path / "pano.jpg")
    stats = str(tmp_path / "stats.json")
    rc = cli.run(
        "serial",
        ["--dir", scene_dir, "--out", out, "--parity", "--kpts", "256",
         "--iters", "128", "--json", stats],
    )
    assert rc == 0
    s = json.load(open(stats))
    h = s["config"]["harris"]
    assert h["ratio_thresh"] == 0.0          # raw argmin matching
    assert h["cross_check"] is False
    assert h["topk_method"] == "exact"
    assert s["config"]["stitch"]["blend"] == "overlay"
    assert s["mode"] == "fold"
    # Explicit flags still override within the preset.
    assert h["max_keypoints"] == 256


def test_opencv_impl_three_timed_phases(scene_dir, tmp_path, capsys):
    out = str(tmp_path / "pano_cv.jpg")
    rc = cli.run("opencv", ["--dir", scene_dir, "--out", out])
    stdout = capsys.readouterr().out
    # The reference's phase labels (src/opencv/main.cpp:40-88), regardless
    # of whether the tiny synthetic scene stitches successfully.
    assert "Reading input images:" in stdout
    assert "Number of images loaded: 2" in stdout
    assert "Stitching process:" in stdout
    if rc == 0:
        assert "Saving panorama:" in stdout


def test_gpu_impl_defaults_to_fused_total_timing(
    scene_dir, tmp_path, capsys, cpu_as_accelerator
):
    """`run gpu` must default to the product (fused single-sync) path: only
    Image Stitching / total lines, no per-stage sync lines. The timing-line
    format itself stays reference-exact, with the reference's "(GPU)" tag
    (src/gpu/main.cpp:335)."""
    import re

    out = str(tmp_path / "pano.jpg")
    rc = cli.run("gpu", ["--dir", scene_dir, "--out", out])
    assert rc == 0
    stdout = capsys.readouterr().out
    assert re.search(r"^Image Stitching \(GPU\): \d+\.\d{3} ms$", stdout, re.M)
    assert re.search(
        r"^Total Stitching Process[^:]*: \d+\.\d{3} ms$", stdout, re.M
    )
    assert re.search(r"^Total Execution Time[^:]*: \d+\.\d{3} ms$", stdout, re.M)
    assert "Harris Corner Detection" not in stdout
    assert "RANSAC Homography Estimation" not in stdout


def test_timing_stages_flag_restores_stage_lines(
    scene_dir, tmp_path, capsys, cpu_as_accelerator
):
    """--timing stages keeps the reference's per-stage stdout contract on
    the accelerator path (benchmark parsers grep these exact labels)."""
    import re

    out = str(tmp_path / "pano.jpg")
    rc = cli.run("gpu", ["--dir", scene_dir, "--out", out,
                         "--timing", "stages"])
    assert rc == 0
    stdout = capsys.readouterr().out
    for label in (
        "Harris Corner Detection",
        "Harris Corner Matching",
        "RANSAC Homography Estimation",
        "Image Stitching",
    ):
        assert re.search(rf"^{label}[^:]*: \d+\.\d{{3}} ms$", stdout, re.M), label


def test_parity_preset_defaults_to_stage_timing(
    scene_dir, tmp_path, capsys, cpu_as_accelerator
):
    """--parity implies the reference's per-stage timing even on gpu."""
    out = str(tmp_path / "pano.jpg")
    rc = cli.run("gpu", ["--dir", scene_dir, "--out", out, "--parity",
                         "--kpts", "256", "--iters", "128"])
    assert rc == 0
    assert "Harris Corner Detection" in capsys.readouterr().out


def test_serve_decode_ahead_prefetches_next_job(scene_dir, tmp_path, monkeypatch):
    """With the next job line already queued, serve must decode its images
    on the worker thread and hand them to run() preloaded, so the codec
    overlaps the current job's device work."""
    import io

    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")
    seen = []
    real_run = cli.run

    def spy(impl, args, config=None, _info=None, _preloaded=None, **kw):
        seen.append(None if _preloaded is None else sorted(_preloaded))
        return real_run(impl, args, _info=_info, _preloaded=_preloaded, **kw)

    monkeypatch.setattr(cli, "run", spy)
    jobs = io.StringIO(
        f"{a1} {a2} --out {tmp_path / 'p1.jpg'}\n"
        f"{a1} {a2} --out {tmp_path / 'p2.jpg'}\n"
        "quit\n"
    )
    rc = cli.serve("serial", ["--kpts", "256"], stdin=jobs)
    assert rc == 0
    assert len(seen) == 2
    assert seen[0] is None                   # nothing to prefetch from
    assert seen[1] == sorted([a1, a2])       # decoded ahead on the worker
    assert os.path.exists(tmp_path / "p1.jpg")
    assert os.path.exists(tmp_path / "p2.jpg")


def test_read_images_preloaded_cache():
    """read_images_from_args must serve paths from the decode-ahead cache
    (including cached None = unreadable, same warning/skip semantics)."""
    import numpy as np

    from pano.io import read_images_from_args

    img = np.full((8, 8, 3), 7, np.uint8)
    res = read_images_from_args(
        ["/definitely/not/a.png", "/definitely/not/b.png", "--out", "o.jpg"],
        preloaded={
            "/definitely/not/a.png": img,
            "/definitely/not/b.png": None,
        },
    )
    assert len(res.images) == 1
    np.testing.assert_array_equal(res.images[0], img)
    assert res.output_file == "o.jpg"


def test_staging_decoder_cache_hit_invalidate_evict(scene_dir, tmp_path,
                                                    monkeypatch):
    """serve's staging decoder: repeated paths are served from the LRU
    (decode runs once per distinct file), a rewritten file (new mtime/size)
    restages instead of serving stale pixels, and the LRU evicts at
    capacity. Unreadable paths map to None and are never cached."""
    import shutil
    import time

    import pano.io as pio

    a1 = os.path.join(scene_dir, "a1.png")
    b2 = str(tmp_path / "b2.png")
    shutil.copy(os.path.join(scene_dir, "a2.png"), b2)

    real_imread = pio.imread_bgr
    decoded = []

    def counting_imread(path):
        decoded.append(path)
        return real_imread(path)

    monkeypatch.setattr(pio, "imread_bgr", counting_imread)
    dec = cli.make_staging_decoder(push_dev=None, cache_cap=2)

    first = dec([a1, b2])
    assert decoded == [a1, b2]
    again = dec([a1, b2])                      # both cache hits
    assert decoded == [a1, b2]
    assert again[a1] is first[a1] and again[b2] is first[b2]

    # Rewrite b2 -> new mtime/size must restage, not serve stale pixels.
    time.sleep(0.01)
    img = cv2.imread(b2)
    cv2.imwrite(b2, np.ascontiguousarray(img[:, ::-1]))
    fresh = dec([b2])
    assert decoded == [a1, b2, b2]
    assert not np.array_equal(np.asarray(fresh[b2]), np.asarray(first[b2]))

    # Capacity 2: touching a third file evicts the least-recently-used (a1).
    c3 = str(tmp_path / "c3.png")
    shutil.copy(a1, c3)
    dec([c3])
    dec([a1])                                   # miss again after eviction
    assert decoded == [a1, b2, b2, c3, a1]

    # Unreadable: None, uncached (retried every call).
    missing = str(tmp_path / "nope.png")
    assert dec([missing])[missing] is None
    assert dec([missing])[missing] is None
    assert decoded.count(missing) == 2


def test_run_accepts_device_resident_preloaded_images(
    scene_dir, tmp_path, cpu_as_accelerator
):
    """Push-ahead contract: serve's worker may stage preloaded images on the
    DEVICE (jax arrays), and run() must produce the same panorama as with
    host arrays — the pipeline's to_dev helpers pass device-resident inputs
    through unchanged."""
    import jax.numpy as jnp

    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")
    host = {p: cv2.imread(p) for p in (a1, a2)}
    dev = {p: jnp.asarray(v, jnp.uint8) for p, v in host.items()}

    out_h = str(tmp_path / "host.jpg")
    out_d = str(tmp_path / "dev.jpg")
    base = ["--kpts", "256", "--iters", "128"]
    assert cli.run("gpu", [a1, a2, "--out", out_h] + base,
                   _preloaded=host) == 0
    assert cli.run("gpu", [a1, a2, "--out", out_d] + base,
                   _preloaded=dev) == 0
    np.testing.assert_array_equal(cv2.imread(out_h), cv2.imread(out_d))


def test_pano_sh_run_propagates_failure_exit_code(tmp_path):
    """The shell driver must exit nonzero when the CLI fails (the reference's
    pano.sh swallows the code — reference pano.sh:207-213; ours
    propagates it so scripts and fleets can branch on it)."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [
            "bash", os.path.join(repo, "pano.sh"), "run", "serial",
            "--no-gpu", str(tmp_path / "nope_a.jpg"),
            str(tmp_path / "nope_b.jpg"),
        ],
        capture_output=True, text=True, timeout=300, cwd=repo,
    )
    assert out.returncode != 0, out.stdout + out.stderr
    assert "Stitching failed with error code" in out.stdout


def test_serve_loop_runs_jobs_and_reports_status(scene_dir, tmp_path, capsys):
    """serve: one warm process, one job per stdin line (run's argument
    surface + default flags), machine-readable Job status lines, and bad
    jobs don't kill the loop."""
    import io

    out1 = str(tmp_path / "serve1.jpg")
    out2 = str(tmp_path / "serve2.jpg")
    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")
    jobs = io.StringIO(
        f"{a1} {a2} --out {out1}\n"
        "\n"                                  # blank: ignored
        f"{a1} --out {tmp_path / 'nope.jpg'}\n"  # 1 image: fails, loop lives
        'broken "quoting\n'                   # shlex error: fails, loop lives
        f"{a1} {a2} --out {out2} --blend feather\n"
        "quit\n"
    )
    rc = cli.serve("serial", ["--kpts", "256"], stdin=jobs)
    assert rc == 0
    stdout = capsys.readouterr().out
    assert f"Job 1 ok {out1}:" in stdout
    assert "Job 2 failed" in stdout
    assert "Job 3 failed -:" in stdout       # machine-readable even on parse error
    assert f"Job 4 ok {out2}:" in stdout
    assert os.path.exists(out1) and os.path.exists(out2)
    assert cv2.imread(out1).shape[1] >= 128
    # Every status line keeps the documented shape `Job <n> <st> <out>: x.xxx ms`.
    import re
    for line in stdout.splitlines():
        if line.startswith("Job "):
            assert re.fullmatch(
                r"Job \d+ (ok|failed) \S+: \d+\.\d{3} ms", line
            ), line


def test_pano_sh_perf_smoke_traces_and_reports(scene_dir, tmp_path):
    """`pano.sh perf` end-to-end on CPU: trace dir creation, report
    writing, PANO_PROFILE plumbing, xprof per-op table append. Reference
    analog: `pano.sh perf` wraps the run in
    `perf record` and appends `perf report --stdio`
    (reference pano.sh:216-243)."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trace_dir = str(tmp_path / "trace")
    out = str(tmp_path / "pano.jpg")
    env = dict(os.environ, PANO_TRACE_DIR=trace_dir)
    # Keep the child's compile fast and hermetic: CPU platform
    # (--no-gpu sets JAX_PLATFORMS=cpu).
    r = subprocess.run(
        [
            "bash", os.path.join(repo, "pano.sh"), "perf", "serial",
            "--no-gpu", "--dir", scene_dir, "--out", out,
        ],
        capture_output=True, text=True, timeout=540,
        cwd=str(tmp_path), env=env,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Performance profiling completed successfully!" in r.stdout
    # The report file carries the stage-line contract plus the per-op table.
    report = tmp_path / "serial_perf_report.txt"
    assert report.is_file(), list(tmp_path.iterdir())
    text = report.read_text()
    assert "Total Stitching Process" in text
    # The xprof per-op table was appended (host-plane fallback on CPU).
    assert "=== plane:" in text, text[-800:]
    # The xplane trace landed where PANO_TRACE_DIR pointed.
    assert os.path.isdir(trace_dir)
    assert any(
        f.endswith(".xplane.pb")
        for _, _, fs in os.walk(trace_dir) for f in fs
    ), "no xplane proto written"
    assert os.path.isfile(out)


def test_serve_encode_behind_defers_write_off_main_thread(
    scene_dir, tmp_path, capsys, monkeypatch
):
    """Encode-behind: with the next job queued, the output image encode
    must run on the worker thread (overlapping the next
    job) and the status line must still mean 'file on disk' — it prints
    only after the write completed, in job order."""
    import io
    import re
    import threading

    out1 = str(tmp_path / "eb1.jpg")
    out2 = str(tmp_path / "eb2.jpg")
    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")

    encode_threads = []
    real_write = cli.imwrite_bgr

    def spy_write(path, img):
        encode_threads.append(threading.current_thread() is threading.main_thread())
        return real_write(path, img)

    monkeypatch.setattr(cli, "imwrite_bgr", spy_write)

    jobs = io.StringIO(
        f"{a1} {a2} --out {out1}\n"
        f"{a1} {a2} --out {out2}\n"
        "quit\n"
    )
    rc = cli.serve("serial", ["--kpts", "256"], stdin=jobs)
    assert rc == 0
    stdout = capsys.readouterr().out
    # Status lines in job order, documented format, and both files written.
    statuses = [l for l in stdout.splitlines() if l.startswith("Job ")]
    assert [s.split()[1] for s in statuses] == ["1", "2"]
    for s in statuses:
        assert re.fullmatch(r"Job \d+ ok \S+: \d+\.\d{3} ms", s), s
    assert f"Stitched result saved to {out1}" in stdout
    assert f"Stitched result saved to {out2}" in stdout
    # 'Job 1 ok' printed only after out1 existed: re-decode both outputs.
    assert cv2.imread(out1) is not None and cv2.imread(out2) is not None
    # Every serve encode ran OFF the main thread (the worker).
    assert encode_threads and not any(encode_threads), encode_threads


def test_bundle_flag_reaches_config(scene_dir, tmp_path):
    """--bundle auto|on|off flows into StitchOptions.bundle_adjust (the
    global-refinement gate, ops/bundle.py) and out through --json."""
    out = str(tmp_path / "pano.jpg")
    stats = str(tmp_path / "stats.json")
    rc = cli.run(
        "serial",
        ["--dir", scene_dir, "--out", out, "--bundle", "off",
         "--kpts", "256", "--iters", "128", "--json", stats],
    )
    assert rc == 0
    s = json.load(open(stats))
    assert s["config"]["stitch"]["bundle_adjust"] == "off"
    with pytest.raises(SystemExit):
        cli.run("serial", ["--bundle", "sometimes", "x.jpg", "y.jpg"])


def test_serve_encode_behind_reports_failed_write(scene_dir, tmp_path, capsys):
    """A deferred encode whose imwrite fails (unwritable path) must turn
    the job's status line into 'failed' — status == file-on-disk."""
    import io

    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")
    bad_out = str(tmp_path / "no_such_dir" / "x.jpg")  # parent missing
    good_out = str(tmp_path / "ok.jpg")
    jobs = io.StringIO(
        f"{a1} {a2} --out {bad_out}\n"
        f"{a1} {a2} --out {good_out}\n"
        "quit\n"
    )
    rc = cli.serve("serial", ["--kpts", "256"], stdin=jobs)
    assert rc == 0
    stdout = capsys.readouterr().out
    assert f"Job 1 failed {bad_out}:" in stdout
    assert f"Job 2 ok {good_out}:" in stdout
    assert not os.path.exists(bad_out)
    assert os.path.exists(good_out)


@pytest.mark.parametrize(
    "impl", sorted({"gpu", "sharded"} | set(cli.IMPL_ALIASES))
)
def test_gpu_impl_refuses_to_run_without_a_gpu(scene_dir, tmp_path, impl):
    """On a machine where JAX sees no GPU the accelerator impls and their
    aliases exit non-zero naming the missing GPU; nothing falls back to
    the CPU."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = tmp_path / f"{impl}.png"
    r = subprocess.run(
        [sys.executable, "-m", "pano.cli", impl, a1, a2, "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=repo, env=env,
    )
    assert r.returncode != 0, (impl, r.stdout, r.stderr)
    assert "no GPU found" in r.stderr, (impl, r.stderr)
    assert not out.exists()


def test_serve_gpu_refuses_to_start_without_a_gpu(capsys):
    """serve's push-ahead asks pano.device for its GPU before it reads any
    job."""
    rc = cli.main(["serve", "gpu"])
    assert rc == -1
    assert "no GPU found" in capsys.readouterr().err
