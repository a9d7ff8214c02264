"""Event-stream noise filters for raw-camera streams (port of
``event_based_optical_flow_tpu/ops/filters.py``).

Real sensors have hot pixels (stuck or leaky pixels firing at kHz
whatever the scene) and shot-noise bursts.  Contrast maximization takes
a hot pixel for a perfect feature, so the EVT2/EVT3 loaders filter at
load time behind ``data.hot_pixel_sigma`` / ``data.refractory_us``.
Host numpy: filtering runs once per recording, next to the decoders.
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)


def _pixel_index(events: np.ndarray, image_shape):
    h, w = image_shape
    xs = np.clip(events[:, 0].astype(np.int64), 0, h - 1)
    ys = np.clip(events[:, 1].astype(np.int64), 0, w - 1)
    return xs, ys


def hot_pixel_mask(events: np.ndarray, image_shape, sigma: float = 5.0,
                   min_rate_hz: float = 500.0) -> np.ndarray:
    """[H, W] bool mask of hot pixels: per-pixel event counts more than
    ``sigma`` robust standard deviations (MAD * 1.4826, at least 1) above
    the median count of the active pixels, and a sustained rate above
    ``min_rate_hz`` over the stream's duration (on noise-dominated streams
    the robust threshold alone would flag genuine edge pixels)."""
    h, w = image_shape
    xs, ys = _pixel_index(events, image_shape)
    counts = np.bincount(xs * w + ys, minlength=h * w).reshape(h, w)
    active = counts[counts > 0]
    if len(active) == 0:
        return np.zeros((h, w), bool)
    med = np.median(active)
    mad = np.median(np.abs(active - med)) * 1.4826
    thresh = med + sigma * max(mad, 1.0)
    t = events[:, 2]
    duration = max(float(t.max() - t.min()), 1e-9)
    return (counts > thresh) & (counts > min_rate_hz * duration)


def remove_hot_pixels(events: np.ndarray, image_shape, sigma: float = 5.0,
                      min_rate_hz: float = 500.0):
    """Drop every event on a hot pixel (``hot_pixel_mask``).  Returns
    (filtered events, [H, W] hot mask)."""
    mask = hot_pixel_mask(events, image_shape, sigma, min_rate_hz)
    if not mask.any():
        return events, mask
    xs, ys = _pixel_index(events, image_shape)
    keep = ~mask[xs, ys]
    logger.info(
        f"hot-pixel filter: {int(mask.sum())} pixels, "
        f"{len(events) - int(keep.sum())} / {len(events)} events dropped"
    )
    return events[keep], mask


def refractory_filter(events: np.ndarray, image_shape, refractory_s: float):
    """Per-pixel refractory period: drop an event when the same pixel
    fired less than ``refractory_s`` seconds earlier, polarity-blind.  The
    time is measured to the previous raw event, dropped or not, so a
    sub-refractory burst keeps only its first event.  Events must be
    time-sorted; their order is kept."""
    if refractory_s <= 0 or len(events) == 0:
        return events
    h, w = image_shape
    xs, ys = _pixel_index(events, image_shape)
    pix = xs * w + ys
    t = events[:, 2]
    order = np.argsort(pix, kind="stable")  # keeps each pixel's time order
    pix_s, t_s = pix[order], t[order]
    same = np.concatenate([[False], pix_s[1:] == pix_s[:-1]])
    dt = np.concatenate([[np.inf], np.diff(t_s)])
    keep = np.ones(len(events), bool)
    keep[order[same & (dt < refractory_s)]] = False
    n_drop = int((~keep).sum())
    if n_drop:
        logger.info(f"refractory filter ({refractory_s * 1e6:.0f} us): "
                    f"{n_drop} / {len(events)} events dropped")
    return events[keep]


def apply_config_filters(events: np.ndarray, image_shape, config: dict) -> np.ndarray:
    """The raw loaders' hook: ``hot_pixel_sigma`` (0 or absent: off, with
    ``hot_pixel_min_rate_hz``), then ``refractory_us``."""
    sigma = float(config.get("hot_pixel_sigma", 0) or 0)
    if sigma > 0:
        rate = float(config.get("hot_pixel_min_rate_hz", 500.0))
        events, _ = remove_hot_pixels(events, image_shape, sigma, rate)
    refr_us = float(config.get("refractory_us", 0) or 0)
    if refr_us > 0:
        events = refractory_filter(events, image_shape, refr_us * 1e-6)
    return events
