"""The serving forward as CUDA-graph replays, one set of graphs per batch
shape.

Launching the serving forward eagerly takes some 750 operator calls on the
serving thread, each of which may give up the interpreter lock to the
preprocess and decode pools and has to win it back. :class:`ServingGraphs`
replays the bodies of two calls of the service's model instead:

(a) the backbone's forward (the embeddings and every layer with its
    attention kernel), and
(b) the decoder's pass over the pair grid on the compact-spot path
    (``PEneoDecoder._grid_forward``: the row blocks through the five heads,
    then ``compact_spots``, or the ``StreamedSpots`` merge with
    ``spot_streaming``).

The modules' own calls stay Python calls, so forward hooks on
``model.backbone``, ``model.peneo_decoder`` and the decoder's
``handshaking_kernel`` fire once a batch, with that batch's values; the
shrink MLP, the combine and ``pack_spots`` run eagerly around the replays.
Hooks on modules inside a segment (a backbone layer, a classifier) fire
only when a segment runs eagerly: at the warm-up and at the capture of a
new shape. The model classes keep their eager code: the segments are
instance attributes of the service's own model (``backbone.forward`` and
``peneo_decoder._grid_forward``) that run the class's code unless the
service arms them for one forward. A replay runs what was captured: a
module setting changed after a service's first batch (the attention
implementation, ``spot_streaming``, the int8 switches) reaches only its
eager forwards.

:class:`GraphedCallable` is the mechanism, after the capture idiom of
``pipeline/train.py`` ``MultiTrainStep``: on the first call with a key (the
shapes and dtypes of its tensor arguments and its other arguments) it
copies the arguments into static buffers, runs the body once on a side
stream (that run's outputs are the call's) and captures it; a later call
copies its arguments into the buffers and replays. Its outputs are laid
out in one flat static buffer inside the graph, and each call returns a
clone of that buffer (one copy on the device), so what a call returned is
never overwritten by a later replay. All graphs of a service share one
memory pool: they replay one after another on the serving thread's stream.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Iterable, Optional

import torch
from torch._utils import _unflatten_dense_tensors
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..models.decoder import pack_spots
from ..utils import tracing

# the counters of one forward of the service, counted inside
# ``serve.dispatch``: the forward's segments replayed, one of them was
# captured (its first batch of a shape), or it ran eagerly
REPLAY, CAPTURE, EAGER = ("serve.graph_replays", "serve.graph_captures",
                          "serve.eager_forwards")


class CudaCapture:
    """What :class:`GraphedCallable` captures with on a CUDA device: the
    warm-up on a side stream, then one CUDA graph per key, every graph of
    this object in one memory pool."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()

    def warm(self, body: Callable[[], object]):
        """``body()`` eagerly on a side stream (builds the kernels' state
        and fills the modules' shape caches before a capture)."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = body()
        current.wait_stream(side)
        return out

    def capture(self, body: Callable[[], torch.Tensor]):
        """``body`` captured as a CUDA graph → (replay, its static output).
        ``thread_local``: the pool threads keep running meanwhile."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            out = body()
        return graph.replay, out


def capture_for(device: torch.device) -> Optional[CudaCapture]:
    """The capture a service on ``device`` replays with: None (eager) off a
    CUDA device."""
    return CudaCapture(device) if device.type == "cuda" else None


def _key(arg):
    if isinstance(arg, torch.Tensor):
        return (tuple(arg.shape), arg.dtype, arg.device)
    return arg


def _pack(leaves):
    """The tensors as one flat uint8 tensor and its layout: the tensors of
    one dtype side by side, the widest dtype first, so that each dtype's
    run starts at a multiple of its element size. The layout lists, per
    dtype, (dtype, byte offset, bytes, the tensors' indices, meta tensors
    of their shapes)."""
    groups: Dict[torch.dtype, list] = {}
    for i, t in enumerate(leaves):
        groups.setdefault(t.dtype, []).append(i)
    layout, parts, offset = [], [], 0
    for dtype, idx in sorted(groups.items(),
                             key=lambda g: -leaves[g[1][0]].element_size()):
        n = sum(leaves[i].numel() for i in idx) * leaves[idx[0]].element_size()
        layout.append((dtype, offset, n, idx,
                       [torch.empty(leaves[i].shape, dtype=dtype,
                                    device="meta") for i in idx]))
        parts += [leaves[i].reshape(-1).view(torch.uint8) for i in idx]
        offset += n
    flat = torch.cat(parts) if parts else torch.empty(0, dtype=torch.uint8)
    return flat, layout


def _unpack(flat, layout):
    """:func:`_pack`'s tensors as views of ``flat``: a few calls a dtype,
    not a few a tensor (each call may give the interpreter lock away)."""
    leaves = [None] * sum(len(idx) for _, _, _, idx, _ in layout)
    for dtype, offset, size, idx, shapes in layout:
        part = flat[offset:offset + size].view(dtype)
        for i, t in zip(idx, _unflatten_dense_tensors(part, shapes)):
            leaves[i] = t
    return leaves


class _Graph:
    """One captured key: its static arguments, replay and output layout,
    and the tensors it reads besides its arguments with their addresses at
    the capture."""

    __slots__ = ("static", "replay", "flat", "layout", "spec", "watched",
                 "addresses")


def _addresses(tensors) -> tuple:
    return tuple(t.data_ptr() for t in tensors)


class GraphedCallable:
    """``fn(*args)`` replayed as CUDA graphs keyed by the arguments' shapes
    and dtypes (tensors; None and plain values enter the key as they are).
    ``fn`` returns a pytree of tensors (dicts, tuples, lists).

    ``capture`` provides ``warm(body)`` and ``capture(body) → (replay,
    static output)`` (:class:`CudaCapture` on the card). ``watch`` gives
    the tensors ``fn`` reads besides its arguments (a module's parameters
    and buffers): a graph reads them where they were at its capture, so a
    key whose tensors have moved since (``module.to``, a ``.data``
    assignment) is captured again. After a call, ``last`` says what it
    did: ``"capture"`` (a new or moved key: the warm-up's outputs were
    returned and the graph captured) or ``"replay"``; ``captures`` counts
    the keys captured."""

    def __init__(self, fn: Callable, capture,
                 watch: Callable[[], Iterable[torch.Tensor]] = tuple) -> None:
        self.fn, self.capture, self.watch = fn, capture, watch
        self.graphs: Dict[tuple, _Graph] = {}
        self.last: Optional[str] = None

    @property
    def captures(self) -> int:
        return len(self.graphs)

    def __call__(self, *args):
        key = tuple(_key(a) for a in args)
        g = self.graphs.get(key)
        if g is None or _addresses(g.watched) != g.addresses:
            self.last = "capture"
            return self._capture(key, args)
        for dst, src in zip(g.static, args):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        g.replay()
        self.last = "replay"
        return tree_unflatten(_unpack(g.flat.clone(), g.layout), g.spec)

    def _capture(self, key, args):
        g = _Graph()
        # the buffers are plain tensors, written by copy_ in any mode
        with torch.inference_mode(False):
            g.static = tuple(a.detach().clone()
                             if isinstance(a, torch.Tensor) else a
                             for a in args)
        out = self.capture.warm(lambda: self.fn(*g.static))

        def body():
            leaves, g.spec = tree_flatten(self.fn(*g.static))
            flat, g.layout = _pack(leaves)
            return flat

        g.replay, g.flat = self.capture.capture(body)
        g.watched = list(self.watch())
        g.addresses = _addresses(g.watched)
        self.graphs[key] = g
        return out


class _Switch:
    """Whether the segments of a service's model replay (one forward);
    with ``pack`` segment (b) also packs the spots, left in ``packed``."""

    __slots__ = ("on", "pack", "packed")

    def __init__(self) -> None:
        self.on = self.pack = False
        self.packed = None


def _state(module):
    """The tensors a module's forward reads: its parameters and buffers."""
    return [*module.parameters(), *module.buffers()]


# The segments are instance attributes of the model's modules that hold the
# module weakly, so that a service's model, its graphs and their memory
# pool go as soon as the service does (no reference cycle to collect).
def _install_backbone(backbone, capture, switch) -> GraphedCallable:
    """Segment (a) on ``backbone.forward``."""
    eager, ref = type(backbone).forward, weakref.ref(backbone)

    def body(input_ids, bbox, attention_mask, image):
        visual = {} if image is None else {"image": image}
        return eager(ref(), input_ids, bbox, attention_mask, **visual)

    graphed = GraphedCallable(body, capture, lambda: _state(ref()))

    def forward(input_ids, bbox, attention_mask=None, image=None,
                generator=None):
        if switch.on:
            return graphed(input_ids, bbox, attention_mask, image)
        visual = {} if image is None else {"image": image}
        return eager(ref(), input_ids, bbox, attention_mask,
                     generator=generator, **visual)

    backbone.forward = forward
    return graphed


def _install_grid(decoder, capture, switch) -> GraphedCallable:
    """Segment (b) on ``decoder._grid_forward``, compact spots only; with
    ``pack`` the graph packs them too (``pack_spots`` of what the decoder
    returns, which its hooks see unchanged)."""
    eager, ref = type(decoder)._grid_forward, weakref.ref(decoder)

    def body(a, b, Ld, pack):
        spots = eager(ref(), a, b, Ld, None, False, None, False)
        return spots, (pack_spots(spots) if pack else ())

    graphed = GraphedCallable(body, capture, lambda: _state(ref()))

    def grid_forward(a, b, Ld, labels, also_decode, label_row_mask,
                     return_logits):
        if switch.on:
            spots, switch.packed = graphed(a, b, Ld, switch.pack)
            return spots
        return eager(ref(), a, b, Ld, labels, also_decode, label_row_mask,
                     return_logits)

    decoder._grid_forward = grid_forward
    return graphed


class ServingGraphs:
    """The forwards of one service's ``model`` (a ``PEneoModel`` it owns):
    segments (a) and (b) of this module's docstring as
    :class:`GraphedCallable` replays, or the eager model.

    A forward replays when all of these hold, each read from what the
    service can observe: ``capture`` is given (a CUDA device); the model is
    in eval mode; its decoder runs neither sequence nor tensor parallelism
    (those forwards hold collectives; data parallelism is fine); the decoder
    is asked for compact spots (no labels, no dense logits,
    ``max_spots_per_head`` > 0); and the batch has ``batch_size`` rows. The
    replays launch the same kernels the eager forward launches, so the two
    routes give the same outputs. Each call counts one of
    :data:`REPLAY`, :data:`CAPTURE` and :data:`EAGER`
    (``utils/tracing.py``)."""

    def __init__(self, model, batch_size: int, capture=None) -> None:
        self.model, self.batch_size = model, batch_size
        self.switch = _Switch()
        self.segments = []
        if capture is not None:
            self.segments = [_install_backbone(model.backbone, capture,
                                               self.switch),
                             _install_grid(model.peneo_decoder, capture,
                                           self.switch)]

    def engages(self, input_ids, labels=None, return_logits=False) -> bool:
        """Whether a forward of these arguments replays (see the class)."""
        decoder = self.model.peneo_decoder
        return (bool(self.segments) and not self.model.training
                and decoder.sp.size == 1 and decoder.tp.size == 1
                and labels is None and not return_logits
                and self.model.cfg.max_spots_per_head > 0
                and input_ids.shape[0] == self.batch_size)

    def __call__(self, input_ids, bbox, attention_mask, image=None,
                 pack=False, **kwargs):
        """``model(input_ids, bbox, attention_mask, image=image,
        **kwargs)``, through the graphs where it :meth:`engages`; with
        ``pack`` its spots packed (``models/decoder.py`` ``pack_spots``)."""
        if not self.engages(input_ids, kwargs.get("labels"),
                            kwargs.get("return_logits", False)):
            tracing.count(EAGER)
            out = self.model(input_ids, bbox, attention_mask, image=image,
                             **kwargs)
            return pack_spots(out) if pack else out
        for s in self.segments:
            s.last = None
        switch = self.switch
        switch.on, switch.pack = True, pack
        try:
            out = self.model(input_ids, bbox, attention_mask, image=image,
                             **kwargs)
            packed = switch.packed
        finally:
            switch.on, switch.packed = False, None
        captured = any(s.last == "capture" for s in self.segments)
        tracing.count(CAPTURE if captured else REPLAY)
        return packed if pack else out
