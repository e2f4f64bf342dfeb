"""CWRU-like synthetic vibration data (paper §3).

The real CWRU bearing dataset is not available offline; this generator
reproduces its *structure*: a rotating-machine vibration series sampled at
48 kHz, in one of 10 states — normal + {inner lace, outer lace, ball} x
{0.18, 0.36, 0.54 mm} fault widths.  Amplitude statistics mirror the paper's
Figures 4–5: the windowed mean |x| of the normal state sits below 0.07 while
every fault state sits above it, and (as in Fig. 5) some fault states overlap
each other so only the CNN can separate *which* fault it is.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

WINDOW = 4096               # samples per inference window (paper: 4096)
SAMPLE_RATE = 48_000        # Hz
BYTES_PER_SAMPLE = 2        # paper: 2-byte registers

STATES = ("normal",
          "inner_018", "inner_036", "inner_054",
          "outer_018", "outer_036", "outer_054",
          "ball_018", "ball_036", "ball_054")

# target windowed mean |x| per state (normal < 0.07 threshold, faults above).
# inner/outer pairs overlap at the larger widths — mirroring Fig. 5 where
# thresholds alone cannot separate them.
_STATE_MEAN = {
    "normal": 0.045,
    "inner_018": 0.110, "inner_036": 0.160, "inner_054": 0.230,
    "outer_018": 0.125, "outer_036": 0.165, "outer_054": 0.235,
    "ball_018": 0.095, "ball_036": 0.140, "ball_054": 0.200,
}
# distinct impulse periodicities let a CNN separate what thresholds cannot
_STATE_FREQ = {s: 40 + 17 * i for i, s in enumerate(STATES)}


def gen_series(state: str, num_windows: int, rng: np.random.Generator,
               motor_load: int = 0) -> np.ndarray:
    """Vibration series of ``num_windows * WINDOW`` samples for one state."""
    n = num_windows * WINDOW
    base = _STATE_MEAN[state] * (1.0 + 0.05 * motor_load)
    noise = rng.normal(0.0, base * 1.2533, size=n)   # E|x| = sigma*sqrt(2/pi)
    if state != "normal":
        # periodic fault impulses (characteristic frequency per fault type)
        t = np.arange(n)
        period = SAMPLE_RATE // _STATE_FREQ[state]
        impulses = ((t % period) < 8).astype(np.float64)
        ring = np.sin(2 * np.pi * t / 23.0) * np.exp(-(t % period) / 40.0)
        noise = noise + 0.8 * base * impulses * ring
    return noise.astype(np.float32)


def windowed_means(series: np.ndarray) -> np.ndarray:
    """Mean |x| per 4096-sample window (the sensor's moving-average S-ML)."""
    w = series[: len(series) // WINDOW * WINDOW].reshape(-1, WINDOW)
    return np.abs(w).mean(axis=1)


def windows_to_images(series: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """(n*4096,) -> (n, 64, 64, 1) grey images, the CNN input of [38].

    FIXED scaling (not per-window min-max): the fault classes differ in
    absolute vibration amplitude as well as impulse periodicity, and
    per-window normalisation would erase the amplitude cue."""
    w = series[: len(series) // WINDOW * WINDOW].reshape(-1, WINDOW)
    img = np.clip(np.abs(w) / scale, 0.0, 1.0)
    return img.reshape(-1, 64, 64, 1).astype(np.float32)


def make_dataset(windows_per_state: int, seed: int = 0,
                 normal_fraction: float = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (images (N,64,64,1), labels (N,), window_means (N,)).

    ``normal_fraction`` optionally over-samples the normal state (machines are
    normal for hundreds of hours — the premise of the bandwidth saving)."""
    rng = np.random.default_rng(seed)
    imgs, labels, means = [], [], []
    for i, s in enumerate(STATES):
        k = windows_per_state
        if normal_fraction is not None:
            if s == "normal":
                k = int(windows_per_state * normal_fraction * len(STATES))
            else:
                k = max(1, int(windows_per_state * (1 - normal_fraction) *
                               len(STATES) / (len(STATES) - 1)))
        series = gen_series(s, k, rng)
        imgs.append(windows_to_images(series))
        means.append(windowed_means(series))
        labels.append(np.full(k, i, np.int32))
    perm = np.random.default_rng(seed + 1).permutation(
        sum(len(x) for x in labels))
    return (np.concatenate(imgs)[perm], np.concatenate(labels)[perm],
            np.concatenate(means)[perm])


def threshold_sml(window_means: np.ndarray, theta: float = 0.07) -> np.ndarray:
    """The paper's S-ML: normal iff windowed mean < theta.  Returns bool
    'is_fault' (= complex sample = offload)."""
    return window_means >= theta


def bandwidth_required(num_machines: int, rebs_per_machine: int = 2) -> float:
    """Mbps to stream everything to the ES (paper: >= 76.8 Mbps for 100
    machines x 2 REBs at 48 kHz x 2 bytes)."""
    return num_machines * rebs_per_machine * SAMPLE_RATE * BYTES_PER_SAMPLE \
        * 8 / 1e6
