"""The least time one NVIDIA H100 needs for the fused warp+vote calls of a
solve, from the shapes the solver's counters give (events per scale and
frame, launches per form and scale) and the published peaks.

Per call of a form on a frame of N events and H x W images, with K
reference-time offsets: each input read once and each output written once
(the event arrays x, y, dtf, wt; the flow [2, H, W] and, for the tangent,
its direction; the images [K, H, W] written, or read as the cotangent of
the backward forms, which write the flow gradient [2, H, W]), over the HBM
rate; and ``OPS_PER_EVENT_OFFSET`` operations per event and offset over
the float32 rate.  A call's bound is the larger of the two.  A batched
call (the fleet's) is the sum over its frames.  The orig image's one call
per frame and event set is counted as a warped call of K images (a few in
thousands: the bound reads slightly high, never low)."""

# One NVIDIA H100 SXM (NVIDIA's data sheet): HBM bytes/s and float32
# FLOP/s outside the tensor cores, at the card's 700 W limit.
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
# floating-point operations per event and offset, counted from the
# kernels' arithmetic (warp, corner split, weights or their derivatives,
# fixed-point scaling); gathers and atomics are counted as bytes
OPS_PER_EVENT_OFFSET = {"fwd": 30, "bwd": 40, "jvp": 45, "hvp_bwd": 40}
OFFSETS = 3  # the multi-focal cost's images: t = 0, 1 and 0.5
ITEM = 4  # float32


def call_bytes(kind: str, n_events: int, h: int, w: int, k: int = OFFSETS) -> int:
    """Bytes one call on one frame reads and writes at least."""
    events = 4 * n_events * ITEM
    flow = 2 * h * w * ITEM
    images = k * h * w * ITEM
    return {"fwd": events + flow + images,
            "bwd": events + flow + images + flow,
            "jvp": events + 2 * flow + images,
            "hvp_bwd": events + flow + images + flow}[kind]


def call_seconds(kind: str, n_events: int, h: int, w: int, k: int = OFFSETS) -> float:
    """The least seconds of one call on one frame: bytes or operations."""
    t_bytes = call_bytes(kind, n_events, h, w, k) / H100_BYTES_PER_S
    t_ops = OPS_PER_EVENT_OFFSET[kind] * n_events * k / H100_FP32_FLOPS
    return max(t_bytes, t_ops)


def solve_seconds(stats: dict, image_shape) -> float:
    """The least seconds of every fused call a solve's stats count:
    ``stats["launches"][scale]`` per form (``fwd``, ``batched_fwd``, ...;
    the voxel forms are not counted) and ``stats["events"][scale]`` (an
    int, or a list per frame of a batch)."""
    h, w = image_shape
    total = 0.0
    for scale, launches in stats["launches"].items():
        events = stats["events"][scale]
        per_frame = events if isinstance(events, (list, tuple)) else [events]
        for key, n in launches.items():
            kind = key.replace("batched_", "")
            if n == 0 or kind not in OPS_PER_EVENT_OFFSET:
                continue
            frames = per_frame if key.startswith("batched_") else per_frame[:1]
            total += n * sum(call_seconds(kind, int(e), h, w) for e in frames)
    return total


def slice_seconds(stats: dict, launches: dict, image_shape) -> float:
    """The least seconds of the fused calls counted in ``launches`` (a
    slice of the solve whose ``stats`` are given): each form's launches
    times that form's mean least time per launch over the solve."""
    total = 0.0
    for key, n in launches.items():
        if not n or key.replace("batched_", "") not in OPS_PER_EVENT_OFFSET:
            continue
        one = {"launches": {s: {key: per.get(key, 0)} for s, per in stats["launches"].items()},
               "events": stats["events"]}
        calls = sum(per.get(key, 0) for per in stats["launches"].values())
        if calls:
            total += n * solve_seconds(one, image_shape) / calls
    return total
