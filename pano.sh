#!/bin/bash
# Unified driver CLI — same subcommand surface as the reference's pano.sh
# (reference pano.sh:97-130): build | run | perf | eval | help.
# Implementations map to execution configs of the one JAX library instead
# of four separate binaries:
#   serial  -> JAX CPU oracle        (reference: serial_stitching)
#   openmp  -> sharded multi-GPU     (reference: openmp_stitching)
#   gpu     -> single GPU            (reference: gpu_stitching)
#   opencv  -> cv::Stitcher baseline (reference: opencv_impl)

SCRIPT_DIR="$( cd "$( dirname "${BASH_SOURCE[0]}" )" &> /dev/null && pwd )"
PYTHON="${PYTHON:-python3}"
BUILD_DIR="$SCRIPT_DIR/native/build"
NO_GPU=false

usage() {
    echo "Usage:"
    echo "  $0 build [--no-gpu] [--build-dir=DIR]"
    echo "      Verify the environment (imports, JAX backend, native exts)"
    echo "      --no-gpu: CPU-only JAX check; --build-dir: native build dir"
    echo ""
    echo "  $0 run <implementation> <image1> <image2> [<image3> ...] [options]"
    echo "      Run an implementation with image files"
    echo "      implementation: serial, openmp (sharded), gpu, opencv"
    echo ""
    echo "  $0 perf <implementation> <image1> <image2> [<image3> ...] [options]"
    echo "      Run with the JAX profiler; writes <impl>_perf_report.txt and"
    echo "      an xplane trace directory for deep analysis"
    echo ""
    echo "  $0 eval <generated_panorama> <reference_panorama>"
    echo "      Evaluate stitching quality against a reference panorama"
    echo ""
    echo "  $0 serve <implementation> [default options] < jobs.txt"
    echo "      Persistent serving loop: one warm process, one job per stdin"
    echo "      line (same argument surface as 'run'); amortizes compile and"
    echo "      graph-dispatch costs across jobs. 'quit' or EOF ends."
    echo ""
    echo "Options for 'run' and 'perf':"
    echo "  --dir <directory>      Use all images in the specified directory"
    echo "  --out <filename>       Output filename (default: result.jpg)"
    echo "  --no-gpu               Force the CPU JAX backend (reference:"
    echo "                         gpu-less build dirs, pano.sh --no-gpu);"
    echo "                         the gpu and sharded impls then refuse to run"
    echo "  (plus pipeline flags: --mode, --blend, --bundle, --timing total|stages, --parity, --json, ...)"
    echo ""
    echo "Examples:"
    echo "  $0 run gpu images/mountain/mountain1.jpg images/mountain/mountain2.jpg"
    echo "  $0 run serial --dir images/oilseed/ --out oilseed_panorama.jpg"
    echo "  $0 eval result.jpg images/oilseed-ref.jpg"
    exit 1
}

if [ $# -lt 1 ]; then
    usage
fi

COMMAND=$1
shift

# Strip driver-level options shared by run/perf (reference
# process_common_args, reference pano.sh:60-76): --build-dir= points
# at an alternate native build, --no-gpu forces the CPU JAX backend (the
# analog of the reference's gpu-less build dirs / BUILD_GPU=OFF).
process_common_args() {
    COMMON_ARGS=()
    while [ $# -gt 0 ]; do
        case $1 in
            --build-dir=*)
                BUILD_DIR="${1#*=}"
                # cmake below runs inside native/, so anchor relative paths
                # there for build AND run alike.
                case $BUILD_DIR in
                    /*) ;;
                    *) BUILD_DIR="$SCRIPT_DIR/native/$BUILD_DIR" ;;
                esac
                ;;
            --no-gpu)
                NO_GPU=true
                ;;
            *)
                COMMON_ARGS+=("$1")
                ;;
        esac
        shift
    done
}

run_env() {
    # Environment for pano.cli invocations, honoring the driver flags.
    ENV_VARS=(PYTHONPATH="$SCRIPT_DIR:$PYTHONPATH")
    [ -f "$BUILD_DIR/libpano_host.so" ] && \
        ENV_VARS+=(PANO_HOST_LIB="$BUILD_DIR/libpano_host.so")
    $NO_GPU && ENV_VARS+=(JAX_PLATFORMS=cpu)
}

case $COMMAND in
    build)
        process_common_args "$@"
        echo "=== Building pano ==="
        cd "$SCRIPT_DIR" || exit 1
        if command -v cmake >/dev/null 2>&1; then
            echo "Building native host library (native/pano_host.cpp) in $BUILD_DIR..."
            (cd native && cmake -B "$BUILD_DIR" -G Ninja . >/dev/null && \
                cmake --build "$BUILD_DIR" >/dev/null) \
                && echo "native: $BUILD_DIR/libpano_host.so" \
                || echo "native build failed: it needs OpenCV's C++ libraries" \
                        "(core, imgcodecs); the Python readers will be used"
        fi
        BUILD_ENV=()
        $NO_GPU && BUILD_ENV=(env JAX_PLATFORMS=cpu)
        "${BUILD_ENV[@]}" "$PYTHON" - <<'EOF' || { echo "Build check failed"; exit 1; }
import jax
import pano
print(f"pano {pano.__version__}")
print(f"jax {jax.__version__}, backend: {jax.default_backend()}, "
      f"devices: {len(jax.devices())}")
EOF
        echo "=== Build check completed successfully ==="
        ;;

    run)
        if [ $# -lt 1 ]; then
            echo "Error: Missing implementation"
            usage
        fi
        IMPL=$1
        shift
        process_common_args "$@"
        run_env
        echo "Running $IMPL implementation..."
        env "${ENV_VARS[@]}" "$PYTHON" -m pano.cli "$IMPL" "${COMMON_ARGS[@]}"
        RC=$?
        # Propagate the CLI's exit code (the reference driver prints the same
        # messages but always exits 0 — reference pano.sh:207-213 even
        # reports "$?" after the if-test clobbered it; scripts and fleets
        # need the real rc).
        if [ $RC -eq 0 ]; then
            echo "Stitching completed successfully!"
        else
            echo "Stitching failed with error code $RC"
        fi
        exit $RC
        ;;

    serve)
        if [ $# -lt 1 ]; then
            echo "Error: Missing implementation"
            usage
        fi
        IMPL=$1
        shift
        process_common_args "$@"
        run_env
        env "${ENV_VARS[@]}" "$PYTHON" -m pano.cli serve "$IMPL" "${COMMON_ARGS[@]}"
        ;;

    perf)
        if [ $# -lt 1 ]; then
            echo "Error: Missing implementation"
            usage
        fi
        IMPL=$1
        shift
        process_common_args "$@"
        run_env
        # PANO_TRACE_DIR overrides the trace location (tests point it
        # at a tmp dir; default matches the reference's in-repo layout).
        TRACE_DIR="${PANO_TRACE_DIR:-${SCRIPT_DIR}/${IMPL}_perf_trace}"
        echo "Running performance profiling on $IMPL implementation..."
        env "${ENV_VARS[@]}" PANO_PROFILE="$TRACE_DIR" \
            "$PYTHON" -m pano.cli "$IMPL" "${COMMON_ARGS[@]}" | tee "${IMPL}_perf_report.txt"
        RC=${PIPESTATUS[0]}
        if [ $RC -eq 0 ]; then
            echo "Performance profiling completed successfully!"
            echo "Performance report saved to ${IMPL}_perf_report.txt"
            echo "Profiler trace (xplane) saved to ${TRACE_DIR}"
            # Per-op device-time table (the reference's `perf report --stdio`
            # analog, reference pano.sh:231-235) appended to the report.
            if "$PYTHON" "${SCRIPT_DIR}/tools/xprof_summary.py" \
                    "$TRACE_DIR" --top 25 >> "${IMPL}_perf_report.txt" 2>/dev/null; then
                echo "Per-op device summary appended to ${IMPL}_perf_report.txt"
            fi
        else
            echo "Performance profiling failed with error code $RC"
        fi
        exit $RC
        ;;

    eval)
        if [ $# -lt 2 ]; then
            echo "Error: Missing panorama images"
            echo "Usage: $0 eval <generated_panorama> <reference_panorama>"
            exit 1
        fi
        GENERATED_PANORAMA=$1
        REFERENCE_PANORAMA=$2
        if [ ! -f "$GENERATED_PANORAMA" ]; then
            echo "Error: Generated panorama file not found: $GENERATED_PANORAMA"
            exit 1
        fi
        if [ ! -f "$REFERENCE_PANORAMA" ]; then
            echo "Error: Reference panorama file not found: $REFERENCE_PANORAMA"
            exit 1
        fi
        echo "Evaluating panorama quality..."
        PYTHONPATH="$SCRIPT_DIR:$PYTHONPATH" "$PYTHON" \
            "$SCRIPT_DIR/evaluate_panorama.py" "$GENERATED_PANORAMA" "$REFERENCE_PANORAMA"
        RC=$?
        if [ $RC -eq 0 ]; then
            echo "Evaluation completed successfully!"
        else
            echo "Evaluation failed with error code $RC"
        fi
        exit $RC
        ;;

    help)
        usage
        ;;

    *)
        echo "Unknown command: $COMMAND"
        usage
        ;;
esac
