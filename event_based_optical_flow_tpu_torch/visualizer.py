"""Host-side visualization of the port (port of
``event_based_optical_flow_tpu/visualizer.py``): IWE images, HSV flow
colorization, overlays and the loss-history plots.

The same API and files as the JAX package's: auto-numbered per-prefix
file names (``original0.png``, ``pred_warp0.png``, ...), the DSEC-style
``ord=0.5`` magnitude colorization (through cv2, matplotlib's
``hsv_to_rgb`` without it), the flow-on-event-mask, overlay and pred-and-GT
composites.  PNG encoding and writing run on a background pool of two
threads; file names are allocated synchronously, so the numbering is the
call order, and ``flush`` waits for the pool and re-raises the first
failed write.

Every event image of this module is a vote through ``ops.iwe`` (K8 for
events on the card, the plain version on the CPU): the clipped IWE, the
event mask of the flow-on-event-mask composite and the grayscale polarity
image (integer positions, so the vote is the JAX package's ``np.add.at``
histogram exactly).

The history plot (``visualize_scipy_history``) is drawn with PIL's
``ImageDraw`` on the save pool, not with matplotlib's ``pyplot`` as in the
JAX package: the GPU machine has no matplotlib.  Same file names, same
series (the weighted loss components and the loss); other pixels.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch
from PIL import Image, ImageDraw

from .ops.iwe import bilinear_vote, create_iwe, event_mask
from .utils.tracing import read

# the history plot: canvas, plot-area margins (left, top, right, bottom) and
# one color per series (matplotlib's default cycle)
PLOT_SIZE = (640, 480)
PLOT_MARGINS = (80, 20, 20, 40)
PLOT_COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2", "#7f7f7f")


def _hsv_to_rgb_uint8(hsv: np.ndarray) -> np.ndarray:
    """HSV (uint8, hue 0-179 as in OpenCV) -> RGB uint8."""
    try:
        import cv2

        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    except ImportError:
        from matplotlib.colors import hsv_to_rgb

        h = hsv[..., 0].astype(np.float64) / 180.0
        s = hsv[..., 1].astype(np.float64) / 255.0
        v = hsv[..., 2].astype(np.float64) / 255.0
        rgb = hsv_to_rgb(np.stack([h, s, v], axis=-1))
        return (rgb * 255).astype(np.uint8)


def clip_iwe(iwe: np.ndarray, max_scale: float) -> np.ndarray:
    """The uint8 visualization of an IWE: ``255 - clip(max_scale * iwe, 0,
    255)`` truncated (dark where events pile up), in the image's own dtype
    as the JAX package computes it."""
    return 255 - np.clip(max_scale * iwe, 0, 255).astype(np.uint8)


def history_plot(series: Dict[str, np.ndarray]) -> Image.Image:
    """A ``PLOT_SIZE`` line plot of each named series over its index (one
    shared value axis, non-finite values skipped), with a legend."""
    width, height = PLOT_SIZE
    left, top, right, bottom = PLOT_MARGINS
    x1, y1 = width - right, height - bottom
    image = Image.new("RGB", PLOT_SIZE, "white")
    draw = ImageDraw.Draw(image)
    finite = [v[np.isfinite(v)] for v in series.values()]
    values = np.concatenate(finite) if finite else np.zeros(0)
    lo, hi = (float(values.min()), float(values.max())) if values.size else (0.0, 1.0)
    if hi <= lo:
        lo, hi = lo - 0.5, hi + 0.5
    n_max = max([len(v) for v in series.values()] + [2])

    def point(i: int, v: float):
        return (left + (x1 - left) * i / (n_max - 1), y1 - (y1 - top) * (v - lo) / (hi - lo))

    draw.rectangle((left, top, x1, y1), outline="black")
    for v, y in ((hi, top), ((lo + hi) / 2, (top + y1) / 2), (lo, y1)):
        draw.line((left - 4, y, left, y), fill="black")
        draw.text((4, y - 6), f"{v:.4g}", fill="black")
    for i in (0, n_max - 1):
        x = point(i, lo)[0]
        draw.line((x, y1, x, y1 + 4), fill="black")
        draw.text((x - 4, y1 + 8), str(i), fill="black")
    for k, (name, v) in enumerate(series.items()):
        color = PLOT_COLORS[k % len(PLOT_COLORS)]
        points = [point(i, float(x)) for i, x in enumerate(v) if np.isfinite(x)]
        if len(points) > 1:
            draw.line(points, fill=color, width=2)
        elif points:
            px, py = points[0]
            draw.ellipse((px - 2, py - 2, px + 2, py + 2), fill=color)
        ly = top + 8 + 14 * k
        draw.line((x1 - 150, ly + 6, x1 - 130, ly + 6), fill=color, width=2)
        draw.text((x1 - 125, ly), name, fill="black")
    return image


class Visualizer:
    """Args:
        image_shape (tuple) ... [H, W]
        show (bool) / save (bool) / save_dir (str)
        async_save (bool) ... encode and write on the background pool
        device ... where the event images are voted (``cuda``: K8)
    """

    def __init__(self, image_shape: tuple, show=False, save=False, save_dir=None, async_save: bool = True,
                 device="cuda") -> None:
        self.device = torch.device(device)
        self.update_image_shape(image_shape)
        self._show = show
        self._save = save
        self.update_save_dir(save_dir or "./")
        self.default_prefix = ""
        self.default_save_count = 0
        self.prefixed_save_count: Dict[str, int] = {}
        self._async_save = async_save
        self._save_pool = None
        self._pending_saves: list = []

    def _submit(self, fn, *args) -> None:
        """Run ``fn(*args)`` (an encode and write) on the save pool, or here
        without ``async_save``."""
        if not self._async_save:
            fn(*args)
            return
        if self._save_pool is None:
            self._save_pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="evflow_viz")
        self._pending_saves.append(self._save_pool.submit(fn, *args))

    def flush(self) -> None:
        """Wait for queued image writes; re-raise the first failure."""
        pending, self._pending_saves = self._pending_saves, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        """``flush``, then stop the save pool."""
        try:
            self.flush()
        finally:
            if self._save_pool is not None:
                self._save_pool.shutdown()
                self._save_pool = None

    def update_image_shape(self, image_shape):
        self._image_size = tuple(image_shape)
        self._image_height, self._image_width = self._image_size

    def update_save_dir(self, new_dir: str) -> None:
        self.save_dir = new_dir
        os.makedirs(self.save_dir, exist_ok=True)

    def _events(self, events) -> torch.Tensor:
        """[n, 4] events (numpy or a tensor) on the visualizer's device."""
        if torch.is_tensor(events):
            return events.to(self.device)
        return torch.as_tensor(np.asarray(events, dtype=np.float64), device=self.device)

    # --- file names -----------------------------------------------------------
    def get_filename_from_prefix(self, prefix: Optional[str] = None, file_format: str = "png") -> str:
        if not prefix:
            name = os.path.join(self.save_dir, f"{self.default_prefix}{self.default_save_count}.{file_format}")
            self.default_save_count += 1
        else:
            self.prefixed_save_count[prefix] = self.prefixed_save_count.get(prefix, -1) + 1
            name = os.path.join(self.save_dir, f"{prefix}{self.prefixed_save_count[prefix]}.{file_format}")
        return name

    def rollback_save_count(self, prefix: Optional[str] = None):
        if not prefix:
            self.default_save_count -= 1
        else:
            self.prefixed_save_count[prefix] -= 1

    def reset_save_count(self, file_prefix: Optional[str] = None):
        if not file_prefix:
            self.default_save_count = 0
        elif file_prefix == "all":
            self.default_save_count = 0
            self.prefixed_save_count = {}
        else:
            del self.prefixed_save_count[file_prefix]

    def _show_or_save_image(self, image, file_prefix=None, fixed_file_name=None):
        if image.mode == "RGBA":
            image = image.convert("RGB")
        if self._show:
            image.show()
        if self._save:
            if fixed_file_name is not None:
                self._submit(image.save, os.path.join(self.save_dir, f"{fixed_file_name}.png"))
            else:
                self._submit(image.save, self.get_filename_from_prefix(file_prefix))

    # --- images ---------------------------------------------------------------
    def load_image(self, image: Any) -> Image.Image:
        if isinstance(image, str):
            return Image.open(image)
        if isinstance(image, np.ndarray):
            return Image.fromarray(image)
        return image

    def visualize_image(self, image: Any, file_prefix: Optional[str] = None) -> Image.Image:
        image = self.load_image(image)
        self._show_or_save_image(image, file_prefix)
        return image

    def create_clipped_iwe_for_visualization(self, events, max_scale=50) -> np.ndarray:
        with torch.no_grad():
            iwe = create_iwe(self._events(events), self._image_size, sigma=0)
        return clip_iwe(read(iwe, "viz").numpy(), max_scale)

    # --- optical flow ---------------------------------------------------------
    def color_optical_flow(self, flow_x, flow_y, max_magnitude=None, ord: float = 1.0):
        """HSV colorization; hue = angle, value = |flow|^ord."""
        flows = np.stack((flow_x, flow_y), axis=2)
        flows[np.isinf(flows)] = 0
        flows[np.isnan(flows)] = 0
        mag = np.linalg.norm(flows, axis=2) ** ord
        # angle from the sanitized components: NaN/inf inputs land at hue 0
        ang = (np.arctan2(flows[:, :, 1], flows[:, :, 0]) + np.pi) * 180.0 / np.pi / 2.0
        hsv = np.zeros(flow_x.shape + (3,), dtype=np.uint8)
        hsv[:, :, 0] = ang.astype(np.uint8)
        hsv[:, :, 1] = 255
        if max_magnitude is None:
            max_magnitude = mag.max()
        hsv[:, :, 2] = np.clip(255 * mag / (max_magnitude + 1e-12), 0, 255).astype(np.uint8)
        flow_rgb = _hsv_to_rgb_uint8(hsv)

        n = flow_x.shape[0]
        xx, yy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n))
        wmag = np.linalg.norm(np.stack((xx, yy), axis=2), axis=2)
        wang = (np.arctan2(xx, yy) + np.pi) * 180 / np.pi / 2.0
        hsv = np.zeros((n, n, 3), dtype=np.uint8)
        hsv[:, :, 0] = wang.astype(np.uint8)
        hsv[:, :, 1] = 255
        hsv[:, :, 2] = (255 * wmag / wmag.max()).astype(np.uint8)
        color_wheel = _hsv_to_rgb_uint8(hsv)
        return flow_rgb, color_wheel, max_magnitude

    def visualize_optical_flow(self, flow_x, flow_y, visualize_color_wheel=True, file_prefix=None,
                               save_flow=False, ord: float = 0.5):
        if save_flow:
            save_name = self.get_filename_from_prefix(file_prefix).replace("png", "npy")
            np.save(save_name, np.stack([flow_x, flow_y], axis=0))
            self.rollback_save_count(file_prefix)
        flow_rgb, color_wheel, _ = self.color_optical_flow(flow_x, flow_y, ord=ord)
        image = Image.fromarray(flow_rgb)
        self._show_or_save_image(image, file_prefix)
        if visualize_color_wheel:
            self._show_or_save_image(Image.fromarray(color_wheel), fixed_file_name="color_wheel")
        return image

    def visualize_overlay_optical_flow_on_event(self, flow, events, file_prefix=None, ord: float = 0.5):
        """The flow's colorization blended over an event image (``[n, 4]``
        events) or over an image (e.g. a clipped IWE)."""
        _show, _save = self._show, self._save
        self._show, self._save = False, False
        try:
            flow = np.asarray(flow)
            flow_image = self.visualize_optical_flow(flow[0], flow[1], ord=ord)
            flow_image.putalpha(int(255 * 0.8))
            if np.ndim(events) == 2 and np.shape(events)[1] == 4:
                event_image = self.visualize_event(events, grayscale=False).convert("RGB")
            else:
                event_image = self.visualize_image(np.asarray(events)).convert("RGB")
            event_image.putalpha(255 - int(255 * 0.8))
            flow_image.paste(event_image, None, event_image)
        finally:
            self._show, self._save = _show, _save
        self._show_or_save_image(flow_image, file_prefix)
        return flow_image

    def visualize_optical_flow_on_event_mask(self, flow, events, file_prefix=None, ord: float = 0.5,
                                             max_color_on_mask: bool = True):
        """The flow's colorization on the pixels the events vote to, white
        elsewhere (``max_color_on_mask``: normalized over those pixels)."""
        _show, _save = self._show, self._save
        self._show, self._save = False, False
        try:
            with torch.no_grad():
                mask = read(event_mask(self._events(events), self._image_size), "viz").numpy()
            flow = np.asarray(flow)
            if max_color_on_mask:
                masked = flow * mask
                image = self.visualize_optical_flow(masked[0], masked[1], False, file_prefix, ord=ord)
            else:
                image = self.visualize_optical_flow(flow[0], flow[1], False, file_prefix, ord=ord)
            pil_mask = Image.fromarray((~mask)[0]).convert("1")
            white = Image.new("RGB", image.size, (255, 255, 255))
            masked_image = Image.composite(white, image, pil_mask)
        finally:
            self._show, self._save = _show, _save
        self._show_or_save_image(masked_image, file_prefix)
        return masked_image

    def visualize_optical_flow_pred_and_gt(self, flow_pred, flow_gt, visualize_color_wheel=True,
                                           pred_file_prefix=None, gt_file_prefix=None, ord: float = 0.5):
        """Prediction and GT colorized on their shared max magnitude."""
        _, _, max_pred = self.color_optical_flow(flow_pred[0], flow_pred[1], ord=ord)
        _, _, max_gt = self.color_optical_flow(flow_gt[0], flow_gt[1], ord=ord)
        mm = max(max_pred, max_gt)
        color_pred, _, _ = self.color_optical_flow(flow_pred[0], flow_pred[1], mm, ord=ord)
        color_gt, wheel, _ = self.color_optical_flow(flow_gt[0], flow_gt[1], mm, ord=ord)
        self._show_or_save_image(Image.fromarray(color_pred), pred_file_prefix)
        self._show_or_save_image(Image.fromarray(color_gt), gt_file_prefix)
        if visualize_color_wheel:
            self._show_or_save_image(Image.fromarray(wheel), fixed_file_name="color_wheel")

    # --- events ---------------------------------------------------------------
    def visualize_event(self, events, grayscale: bool = True, background_color: int = 127,
                        ignore_polarity: bool = False, file_prefix=None) -> Image.Image:
        """The events at their truncated (clipped) pixels: a polarity (or
        count) histogram in gray, or red / blue per polarity."""
        events = np.array(read(events, "viz"), dtype=np.float64, copy=True)
        events[:, 0] = np.clip(events[:, 0], 0, self._image_size[0] - 1)
        events[:, 1] = np.clip(events[:, 1], 0, self._image_size[1] - 1)
        pixels = events[:, :2].astype(np.int32)
        if grayscale:
            if ignore_polarity:
                weight = 1.0
            else:
                pol = events[:, 3] * 2 - 1 if np.min(events[:, 3]) == 0 else events[:, 3]
                weight = torch.as_tensor(pol, device=self.device)
            at = np.concatenate([pixels, np.zeros((len(pixels), 2))], axis=1)
            with torch.no_grad():
                counts = bilinear_vote(self._events(at), self._image_size, weight)
            return self.visualize_event_image(1.0 + read(counts, "viz").numpy(), background_color, file_prefix)
        image = np.full(self._image_size + (3,), 255, dtype=np.uint8)
        colors = np.where(events[:, 3:4] == 1, np.array([[255, 0, 0]]), np.array([[0, 0, 255]]))
        image[pixels[:, 0], pixels[:, 1]] = colors
        pil = Image.fromarray(image)
        self._show_or_save_image(pil, file_prefix)
        return pil

    def visualize_event_image(self, eventimage, background_color: int = 255, file_prefix=None) -> Image.Image:
        background = eventimage == 0
        rng = eventimage.max() - eventimage.min()
        eventimage = (255 * (eventimage - eventimage.min()) / (rng + 1e-12)).astype(np.uint8)
        if background_color == 255:
            eventimage = 255 - eventimage
        else:
            eventimage[background] = background_color
        pil = Image.fromarray(eventimage)
        self._show_or_save_image(pil, file_prefix)
        return pil

    def save_array(self, array: np.ndarray, file_prefix=None, new_prefix: bool = False) -> None:
        save_name = self.get_filename_from_prefix(file_prefix).replace("png", "npy")
        np.save(save_name, array)
        if not new_prefix:
            self.rollback_save_count(file_prefix)

    # --- history --------------------------------------------------------------
    def visualize_scipy_history(self, cost_history: dict, cost_weight: Optional[dict] = None):
        """The loss history and each component's, weighted by
        ``cost_weight`` ("inv" as 1), as ``optimization_steps<N>.png``: the
        name is allocated here, the plot drawn and written on the save
        pool."""
        if not self._save:
            return
        series = {}
        for k, v in cost_history.items():
            w = 1.0 if k == "loss" or cost_weight is None or k not in cost_weight else cost_weight[k]
            series[k] = np.array(v, dtype=np.float64) * (1.0 if w == "inv" else w)
        name = self.get_filename_from_prefix("optimization_steps")
        self._submit(lambda: history_plot(series).save(name))

    def visualize_sampling_history(self, losses, file_prefix: str = "sampling_steps"):
        """The sampling ("optuna") optimizer's history plot (the reference's
        ``visualize_optuna_history`` is undefined; the JAX package plots it
        as a loss history)."""
        self.visualize_scipy_history({"loss": list(np.asarray(losses).reshape(-1))})
