#!/usr/bin/env python3
"""Panorama quality evaluator CLI — same interface as the reference's
evaluate_panorama.py (usage: evaluate_panorama.py <baseline> <test>
[--threshold px]); implementation lives in pano.eval."""

import argparse
import sys

import cv2

from pano.eval import compute_metrics, evaluate_quality


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("baseline", help="Baseline panorama image")
    parser.add_argument("test", help="Test panorama image")
    parser.add_argument(
        "--threshold",
        type=float,
        default=3.0,
        help="RANSAC reproj threshold in pixels",
    )
    args = parser.parse_args()

    img1 = cv2.imread(args.baseline)
    img2 = cv2.imread(args.test)
    if img1 is None or img2 is None:
        raise RuntimeError("Failed to load images")

    metrics = compute_metrics(img1, img2, reproj_threshold=args.threshold)
    evaluate_quality(metrics)


if __name__ == "__main__":
    main()
