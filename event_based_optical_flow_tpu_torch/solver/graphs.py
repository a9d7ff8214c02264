"""Newton-CG's evaluations replayed from CUDA graphs: the port's counterpart
of the JAX package's whole-frame chain (``event_based_optical_flow_tpu/
solver/pyramid.py::_optimize_chain``, the coarse-to-fine loop under one
``jax.jit``).

The JAX chain runs the per-scale loop's kernels in the loop's order as one
device program.  Here the Newton loop stays on the host: its conditions
read the same flags, so a frame's host syncs do not change.  What runs
between two reads is captured once as a CUDA graph and replayed, so one
replay enqueues what was hundreds of kernel launches.  These are the
evaluations of one Newton problem (one scale's objective on one event set):

* ``value(x)`` (line search, escape probe) and ``value_grad(x)`` (autograd
  inside the capture);
* ``fd_hvp``: central (both gradients and their difference) or one-sided,
  with ``eps`` computed on the device from ``|x|`` and ``|p|``;
* the analytic HVP's ``prep(x)`` (once per CG solve) and ``hvp(aux, x, p)``.

The fleet's lockstep Newton (``fleet.BatchedNewtonCG``, the port's
counterpart of the JAX package's ``_optimize_batch_chain``) takes the same
evaluations of a batch: a stage of a ``FleetEvents`` serves the batched
closures (``newton_cg.BatchedEvaluations``: per-frame losses, the gradient
of their sum, each frame's FD step).

Staging.  An evaluation reads static buffers: its own inputs (x, p, the
iterate's gradient, the prep's images), copied in before each call, and its
event set's ``Stage``: the ``FrameEvents`` (or ``FleetEvents``) and the orig
IWE, copied in once per frame or batch (``ChainGraphs.stage``).  A stage is
keyed by its event set ("full", "coarse"; the fleet's "fleet-full",
"fleet-coarse"), its exact event count (a batch: its frame count and each
frame's event count), whether it has time bins, and its dtype; the
evaluations within it by the objective's spec and curvature model and by
kind.  A frame or batch with other event counts stages and captures anew.
Events are not padded to share graphs: a padded event changes no sum, but
it could move K3's per-frame tangent bound and with it the tangent's bits.

Capture.  The first call of an evaluation runs it on a side stream (the
warm-up PyTorch's capture needs, and this call's result), then captures it
there into a graph on the solver's one memory pool; every later call
replays the graph.  Python's garbage collector is off during a capture: a
dead solver's graph that a collection destroyed there would reset itself
inside the capture and invalidate it.  Results are cloned off the graph's static outputs, so
none is overwritten by a later replay of a graph that shares the pool.  A
capture that fails raises: a host read inside an evaluation is a fault,
not a reason to run eagerly.  The kernels' launch counts
(``ops.launch_counts``) are kept by their wrappers, which a replay does not
call: a graph records its capture's counts, takes them back (a capture
launches nothing) and adds them at every replay, so a chained frame counts
the launches the loop counts.

On the CPU the same staging calls the same closures eagerly: no graphs.
The arithmetic is the loop's, op for op, so the chain gives the loop's
bits on either device.
"""

import gc
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from .. import ops
from ..utils.tracing import span
from .newton_cg import BatchedEvaluations, EagerEvaluations
from .objective import FleetEvents, FrameEvents

Tensor = torch.Tensor


class ChainGraphs:
    """A solver's captured evaluations: one CUDA graph memory pool, one
    side stream for warm-ups and captures, and a stage per event set."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.stages: Dict[str, Stage] = {}

    def stage(self, name: str, frame: Union[FrameEvents, FleetEvents], orig: Tensor) -> "Stage":
        """The stage of event set ``name`` holding this frame's (or
        batch's) events and orig IWE: the cached one, with ``frame`` and
        ``orig`` copied in, when its key matches; else a new one that takes
        ``frame`` and ``orig`` as its buffers (its graphs are captured
        anew)."""
        if isinstance(frame, FleetEvents):
            key = (len(frame), frame.frames.sizes, frame.bins is not None, frame.channels is not None, frame.x.dtype)
        else:
            key = (frame.x.shape[0], frame.bins is not None, frame.channels is not None, frame.x.dtype)
        stage = self.stages.get(name)
        if stage is None or stage.key != key:
            stage = self.stages[name] = Stage(self, key, frame, orig)
        else:
            stage.frame.copy_(frame)
            stage.orig.copy_(orig)
        return stage


class Stage:
    """One event set's static buffers (``frame``: a ``FrameEvents``, or a
    batch's ``FleetEvents``; ``orig``) and the evaluations of every
    objective solved on them."""

    def __init__(self, graphs: ChainGraphs, key: tuple, frame, orig: Tensor):
        self.graphs, self.key, self.frame, self.orig = graphs, key, frame, orig
        self.batched = isinstance(frame, FleetEvents)
        self._evaluations: Dict[tuple, StagedEvaluations] = {}

    def evaluations(self, key: tuple, value_fn: Callable, hvp_fn: Optional[Callable] = None,
                    hvp_prep_fn: Optional[Callable] = None) -> "StagedEvaluations":
        """The evaluations of one objective on this stage, cached by
        ``key`` (the objective's spec and curvature model): the closures of
        a later call with the same key compute what the first call's did."""
        if key not in self._evaluations:
            self._evaluations[key] = StagedEvaluations(self, value_fn, hvp_fn, hvp_prep_fn)
        return self._evaluations[key]


class _Captured:
    """One evaluation of one ``kind`` (``value``, ``value_grad``, ...): static
    input buffers and, on CUDA, the graph captured at the first call (the
    span ``graphs.capture``; each later call is a ``graphs.replay``)."""

    def __init__(self, graphs: ChainGraphs, kind: str, body: Callable):
        self.graphs, self.kind, self.body = graphs, kind, body
        self.inputs: Optional[Tuple[Tensor, ...]] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Tuple[Tensor, ...] = ()
        self.launches: Dict[str, int] = {}

    def __call__(self, *args: Tensor) -> Tuple[Tensor, ...]:
        if self.inputs is None:
            self.inputs = tuple(torch.empty_like(a, memory_format=torch.contiguous_format) for a in args)
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        if not self.graphs.cuda:
            return self.body(*self.inputs)
        if self.graph is None:
            with span("graphs.capture", kind=self.kind):
                return self._warm_up_and_capture()
        with span("graphs.replay", kind=self.kind):
            self.graph.replay()
            ops.add_launch_counts(self.launches)
            return tuple(o.clone() for o in self.outputs)

    def _warm_up_and_capture(self) -> Tuple[Tensor, ...]:
        g = self.graphs
        main = torch.cuda.current_stream(g.device)
        g.stream.wait_stream(main)
        with torch.cuda.stream(g.stream):
            result = self.body(*self.inputs)  # this call's evaluation, and the warm-up
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()  # no other graph may be destroyed (and reset) inside this capture
        try:
            with torch.cuda.graph(graph, pool=g.pool, stream=g.stream):
                outputs = self.body(*self.inputs)
        finally:
            if collecting:
                gc.enable()
        after = ops.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        ops.add_launch_counts({k: -v for k, v in self.launches.items()})  # a capture launches nothing
        main.wait_stream(g.stream)
        self.graph, self.outputs = graph, tuple(outputs)
        return result


class StagedEvaluations:
    """``EagerEvaluations``' interface over a stage's buffers, each kind
    of evaluation a ``_Captured`` (the analytic HVP in its staged form);
    on a batch's stage, ``BatchedEvaluations``' closures."""

    def __init__(self, stage: Stage, value_fn: Callable, hvp_fn: Optional[Callable],
                 hvp_prep_fn: Optional[Callable]):
        eager_cls = BatchedEvaluations if stage.batched else EagerEvaluations
        eager = eager_cls(value_fn, (stage.orig, stage.frame), hvp_fn, hvp_prep_fn)
        self.staged = eager.staged
        g = stage.graphs
        self._value = _Captured(g, "value", lambda x: (eager.value(x),))
        self._value_grad = _Captured(g, "value_grad", eager.value_grad)
        self._fd_central = _Captured(g, "fd_central", lambda x, p: (eager.fd_hvp(x, p, None, True),))
        self._fd_one_sided = _Captured(g, "fd_one_sided", lambda x, p, g0: (eager.fd_hvp(x, p, g0, False),))
        self._prep = _Captured(g, "prep", lambda x: (eager.prep(x),))
        self._hvp = _Captured(g, "hvp", lambda aux, x, p: (eager.hvp(aux, x, p),))

    def value(self, x: Tensor) -> Tensor:
        return self._value(x)[0]

    def value_grad(self, x: Tensor):
        return self._value_grad(x)

    def fd_hvp(self, x: Tensor, p: Tensor, g0: Tensor, central: bool) -> Tensor:
        return self._fd_central(x, p)[0] if central else self._fd_one_sided(x, p, g0)[0]

    def prep(self, x: Tensor) -> Tensor:
        return self._prep(x)[0]

    def hvp(self, aux: Tensor, x: Tensor, p: Tensor) -> Tensor:
        return self._hvp(aux, x, p)[0]
