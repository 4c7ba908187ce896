"""Pipeline configuration — single source of truth for all hyperparameters.

Re-design of the reference's option structs, which are re-declared
identically in every implementation (reference: src/serial/main.cpp:24-40,
src/openmp/main.cpp:28-44, src/gpu/main.cpp:28-44, src/gpu/ransac.cuh:9-14).
Here there is exactly one definition, plus the static-shape capacities that an
XLA implementation needs (fixed keypoint/match counts with validity masks,
standing in for the reference's dynamic vectors and its hard caps of 10000
keypoints / 4096 matches at src/gpu/harris_detector.cu:196 and
src/gpu/ransac.cu:14).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HarrisOptions:
    """Harris corner detection + SSD patch matching options.

    Field defaults mirror reference HarrisCornerOptions
    (src/serial/main.cpp:28-34).
    """

    k: float = 0.04                 # Harris detector parameter (k_)
    nms_thresh: float = 1e6        # Harris response threshold (nmsThresh_)
    nms_neighborhood: int = 3      # NMS window size, must be odd (nmsNeighborhood_)
    patch_size: int = 5            # matching patch size (patchSize_)
    max_ssd_thresh: float = 1e8    # SSD matching threshold (maxSSDThresh_)

    # --- static-shape capacities (no reference analog; replaces dynamic
    # std::vector<KeyPoint> with fixed-K masked arrays; the reference's own GPU
    # path caps at 10000, src/gpu/harris_detector.cu:196). 8192 keeps multi-
    # image folds healthy: keypoints spread over the growing panorama, and a
    # small cap starves the new image's overlap region of matches. ---
    max_keypoints: int = 8192      # static K for top-K keypoint selection

    # --- matching robustness (no reference analog; the reference's raw
    # argmin-SSD matching fails on repetitive texture — its own binaries
    # produce single-image "panoramas" on images/oilseed. Both tests are
    # cheap post-passes on the SSD matrix.) ---
    ratio_thresh: float = 0.85     # Lowe ratio: best < r^2 * second-best
    #                                (0 disables)
    cross_check: bool = True       # mutual-nearest-neighbor check
    topk_method: str = "approx"    # 'approx' (lax.approx_max_k at
    #                                topk_recall) | 'exact' (lax.top_k)
    topk_recall: float = 0.92      # recall target handed to approx_max_k
    match_block: int = 0           # SSD matcher memory plan: 0 = auto (dense
    #                                single matmul up to 512 MB, then stream
    #                                train tiles); N > 0 forces the blockwise
    #                                streaming path with tile N (the K x K
    #                                matrix never materializes; bit-identical
    #                                results — ops/match.py)

    def __post_init__(self):
        if self.nms_neighborhood % 2 != 1:
            raise ValueError("nms_neighborhood must be odd")
        if self.nms_neighborhood < 3:
            # The 2x2 block reduction before top-K (ops/harris.py) is
            # lossless only when NMS guarantees pairwise non-adjacent peaks,
            # which needs a neighborhood of at least 3.
            raise ValueError("nms_neighborhood must be >= 3")
        if self.patch_size % 2 != 1:
            raise ValueError("patch_size must be odd")
        if not (0.0 < self.topk_recall <= 1.0):
            raise ValueError("topk_recall must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class RansacOptions:
    """RANSAC homography estimation options.

    Defaults mirror reference RansacOptions (src/serial/main.cpp:36-40).
    """

    num_iterations: int = 1000     # hypothesis count (numIterations_)
    num_samples: int = 4           # minimal sample size (numSamples_)
    distance_threshold: float = 3.0  # inlier reprojection distance in px

    # --- additions over the reference ---
    seed: int = 0                  # jax.random seed (reference uses
    #                                nondeterministic std::random_device,
    #                                src/serial/main.cpp:264-265; we are
    #                                deterministic by design)
    refine: bool = True            # least-squares re-fit on the inliers of the
    #                                best hypothesis, as the reference GPU path
    #                                does (src/gpu/ransac.cu:524-544)
    min_inliers: int = 10          # quality gate before trusting the model
    #                                (src/gpu/ransac.cu:499-511)


@dataclasses.dataclass(frozen=True)
class StitchOptions:
    """Whole-pipeline options (reference PanoramicOptions is empty,
    src/serial/main.cpp:24-26; ours actually carries the compositing and
    execution configuration)."""

    blend: str = "overlay"         # 'overlay' | 'feather' | 'multiband'
    #                                reference implements overlay only
    #                                (src/serial/main.cpp:380-386)
    dtype: str = "float32"         # compute dtype for image math
    canvas_bucket: int = 128       # canvas dims rounded up to this multiple to
    #                                bound XLA recompilation across canvas sizes
    interpolation: str = "bilinear"  # warp sampling, matches cv2 INTER_LINEAR
    gain_compensation: bool = False  # per-image scalar exposure gain from
    #                                the overlap (cv::Stitcher-class feature,
    #                                ops/warp.py::_estimate_gain; the
    #                                reference pipeline has none). In-graph,
    #                                costs no extra host syncs.
    bundle_adjust: str = "auto"    # global frame refinement over the full
    #                                validated pair graph (ops/bundle.py; the
    #                                cv::Stitcher BA analog the native
    #                                reference pipelines lack). 'auto' = run
    #                                when the graph has redundant edges
    #                                (auto mode's all-pairs graph; tree
    #                                graphs are already exact), 'on' =
    #                                always, 'off' = never. Host-side LM
    #                                solve, milliseconds, zero device syncs.


@dataclasses.dataclass(frozen=True)
class PanoConfig:
    harris: HarrisOptions = dataclasses.field(default_factory=HarrisOptions)
    ransac: RansacOptions = dataclasses.field(default_factory=RansacOptions)
    stitch: StitchOptions = dataclasses.field(default_factory=StitchOptions)

    def replace(self, **kw) -> "PanoConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = PanoConfig()
