"""CompiledLadder: a bounded, thread-safe store of built engine programs
with background prewarm, and the port's program-build accounting.

Port of ``pyabc_tpu/autotune/ladder.py:264-419``.  In the JAX package an
entry is an XLA executable; here it is a built engine closure (a fused
block, a one-dispatch run, a study-axis window), which may hold device
buffers of its own.  The ladder is what the JAX package's is:

- **Bounded.**  An LRU of ``capacity`` entries (default 16); every
  eviction counts ``autotune_ladder_evictions_total``.
- **Thread-safe with single-flight builds.**  A ``get`` for a key that is
  already being built (by the prewarm worker or another thread) waits
  for that build instead of building the same program twice.
- **Shared.**  One ladder on the sampler serves every engine the
  orchestrator builds for it (``smc.ABCSMC._block_fn``); the keys carry
  the round kernel's ``_uid``, so a rebind never reuses a stale program.

Build accounting: the port compiles no device program at run time (the
kernels are built once by ``ops/_build.py``), so the JAX package's
``xla_compiles_total`` / ``xla_compile_seconds_total`` count the port's
own program builds — ladder misses and prewarms, and the study axis's
window builds (``serve/multiplex.py``) — through :func:`record_build`.
:func:`install_compile_listener` has nothing to listen to; it registers
the counters so that :func:`compile_counters` reads zeros before the
first build, and is kept for the callers of the JAX package's name.

The ahead-of-time surface (``pyabc_tpu/autotune/ladder.py:55-231``) is
CUDA-graph capture.  Where the JAX package lowers and compiles a program
for exact avals, the port records one call of a function as a
``torch.cuda.CUDAGraph`` and replays it:

- :func:`aval_of` / :func:`avals_like` give a :class:`TensorSpec` (shape,
  dtype, device) of a tensor or of a nested dict / tuple of tensors;
  spec leaves and leaves that are not tensors pass through.
- :func:`jit_compile` wraps a function that captures lazily: one graph
  per argument spec, as ``jax.jit`` keeps one executable per signature.
  With CPU tensors it calls the function (the CPU has no graphs).
- :func:`aot_compile` captures ahead of time for given specs and returns
  an :class:`AotGuard`, which replays the graph and, on spec drift,
  counts ``autotune_aot_signature_misses_total`` and serves the call
  through its ``jit_compile`` wrapper.  It never runs the function
  eagerly on a CUDA tensor.

A graph's static inputs are buffers of the captured specs; each call
copies its tensors in (skipped for a tensor already copied and not
written since) and replays.  A *donated* argument (``donate_argnums``,
the JAX spelling) is different: its tensors are the static inputs
themselves, which the graph updates in place, as the rejection loop's
accept buffers are (``sampler/device_loop.py``); ``donate_keys`` donates
the tensors under those dict keys in any argument (a round's resampling
CDFs, which its caller writes in place between generations).  A
``torch.Generator`` argument is replaced in the graph by a generator of
the graph's own, registered with it
(``CUDAGraph.register_generator_state``); each replay carries the
caller's generator state in and out (host values, no device read), so a
replay draws exactly what the eager call draws from the same state, and
a refused capture, which leaves its registered generator in capture
mode, never touches the run's.  Warm-up before a capture runs on
scratch copies of the arguments and a clone of the generator.

Every capture counts in ``xla_compiles_total`` and
``xla_compile_seconds_total`` (:func:`record_build`).  A call that cannot be
captured — it reads the card from the host, copies between the host and the
card, or makes generators from host state — is refused before any capture
begins: the warm-up (or the caller's probe, :func:`check_capturable`) runs
under a ``TorchFunctionMode`` that sees those calls, and port code that does
such work where no call shows it says so (:func:`note_uncapturable`, from
``device``: it marks the screen open on its own thread only).  A
refusal counts ``autotune_aot_errors_total`` and raises
:class:`CaptureRefused`; the caller decides what runs instead.  A capture that
fails all the same (the card refuses it, or runs out of memory) leaves
PyTorch's allocator recording into its pool when the card invalidated the
capture: that pool is retired, kept alive and never captured into again (a
later capture gets a fresh one).  The error is a refusal when its first line
names the capture, else it propagates (an out-of-memory error in a capture,
which ends cleanly, is retried as any other).  The graphs of one
:class:`CompiledLadder` share its memory pool
(:meth:`CompiledLadder.graph_pool`): a graph's outputs stay valid until the
next replay of any graph of that pool.

Launch counts of the port's kernels (K1's
``weighted_kde_logpdf_cuda.launches``) move with replays: a kernel
registers its counter (:func:`register_launch_counter`), a capture
records how many launches its call made without counting them, and each
replay counts them.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.overrides import TorchFunctionMode

from ..device import capture_screen, note_uncapturable
from ..telemetry import spans as _spans
from ..telemetry.metrics import REGISTRY

logger = logging.getLogger("ABC.Autotune")

__all__ = ["AotGuard", "CaptureRefused", "CompiledLadder", "TensorSpec",
           "aot_compile", "aval_of", "avals_like", "check_capturable",
           "compile_counters", "compile_delta", "install_compile_listener",
           "jit_compile", "note_uncapturable", "record_build",
           "register_launch_counter", "screened_call"]

_COMPILES = ("xla_compiles_total",
             "program builds (engine closures, study-axis windows)")
_COMPILE_S = ("xla_compile_seconds_total",
              "seconds spent building programs")


def install_compile_listener():
    """Register the build counters (idempotent); see the module
    docstring for why there is no listener."""
    REGISTRY.counter(*_COMPILES)
    REGISTRY.counter(*_COMPILE_S)


def record_build(seconds: float):
    """Count one program build of ``seconds``."""
    REGISTRY.counter(*_COMPILES).inc()
    REGISTRY.counter(*_COMPILE_S).inc(max(float(seconds), 0.0))


def compile_counters() -> dict:
    """Scalar snapshot of the build accounting, with the JAX package's
    keys (the persistent-cache counters stay 0: the kernel build cache
    is not consulted per program)."""
    d = REGISTRY.to_dict()
    return {
        "n_compiles": int(d.get("xla_compiles_total", 0)),
        "compile_s": float(d.get("xla_compile_seconds_total", 0.0)),
        "cache_hits": int(d.get("xla_cache_hits_total", 0)),
        "cache_misses": int(d.get("xla_cache_misses_total", 0)),
    }


def compile_delta(before: dict, after: Optional[dict] = None) -> dict:
    """Elementwise ``after - before`` over :func:`compile_counters`
    snapshots (``after`` defaults to now)."""
    if after is None:
        after = compile_counters()
    return {k: after[k] - before.get(k, 0) for k in after}


def _timed_build(build: Callable):
    t0 = time.perf_counter()
    value = build()
    record_build(time.perf_counter() - t0)
    return value


# ---------------------------------------------------------------------------
# the ahead-of-time surface: CUDA-graph capture
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape, dtype and device: the port's
    ``jax.ShapeDtypeStruct``, a leaf of a graph's argument spec."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device


def aval_of(x) -> TensorSpec:
    """The :class:`TensorSpec` of a tensor or array (a spec passes
    through)."""
    if isinstance(x, TensorSpec):
        return x
    if isinstance(x, torch.Tensor):
        return TensorSpec(tuple(x.shape), x.dtype, x.device)
    arr = np.asarray(x)
    return TensorSpec(tuple(arr.shape),
                      torch.from_numpy(np.empty(0, arr.dtype)).dtype,
                      torch.device("cpu"))


def avals_like(tree):
    """``tree`` with every tensor or array leaf replaced by its
    :class:`TensorSpec`; spec leaves and other leaves (a generator, a
    Python scalar, None) pass through unchanged."""
    return pytree.tree_map(
        lambda x: aval_of(x) if isinstance(x, (torch.Tensor, np.ndarray))
        else x, tree)


class CaptureRefused(RuntimeError):
    """The card refused to capture a call as a CUDA graph (an operation
    that reads the card from the host, or one not allowed in a capture);
    counted in ``autotune_aot_errors_total``."""


#: kernels' launch counters: name -> (read, add(n, replayed))
_LAUNCH_COUNTERS: dict = {}


def register_launch_counter(name: str, read: Callable[[], int],
                            add: Callable[[int, bool], None]):
    """Register a kernel's launch counter: ``read()`` gives the count and
    ``add(n, replayed)`` moves it.  A capture takes back the launches its
    call counted (nothing launched) and each replay adds them with
    ``replayed=True``."""
    _LAUNCH_COUNTERS[name] = (read, add)


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return aval_of(x)
    if isinstance(x, TensorSpec):
        return x
    if isinstance(x, torch.Generator):
        return ("generator", x.device)
    try:
        hash(x)
    except TypeError:
        return ("object", id(x))
    return ("static", type(x), x)


def _flatten(args: tuple, donate_argnums=(), donate_keys=()):
    """``(leaves, treedef, donated leaf indices)`` of a call's args: the
    leaves of the ``donate_argnums`` arguments, and each leaf under a
    dict key in ``donate_keys``."""
    leaves, defs, donated = [], [], set()
    for k, a in enumerate(args):
        if donate_keys and k not in donate_argnums:
            pairs, d = pytree.tree_flatten_with_path(a)
            lv = [x for _, x in pairs]
            donated.update(
                len(leaves) + i for i, (path, _) in enumerate(pairs)
                if path and getattr(path[-1], "key", None) in donate_keys)
        else:
            lv, d = pytree.tree_flatten(a)
            if k in donate_argnums:
                donated.update(range(len(leaves), len(leaves) + len(lv)))
        leaves += lv
        defs.append(d)
    return leaves, tuple(defs), frozenset(donated)


def _unflatten(leaves, treedef) -> tuple:
    out, i = [], 0
    for d in treedef:
        n = d.num_leaves
        out.append(pytree.tree_unflatten(list(leaves[i:i + n]), d))
        i += n
    return tuple(out)


def _card_device(leaves):
    """The CUDA device of the first CUDA tensor or spec leaf, or None."""
    for x in leaves:
        dev = getattr(x, "device", None)
        if isinstance(x, (torch.Tensor, TensorSpec)) and dev.type == "cuda":
            return dev
    return None


def _clone_generator(gen: torch.Generator) -> torch.Generator:
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


#: calls that read the card from the host (a capture cannot hold them)
_HOST_READS = frozenset((
    "__bool__", "__int__", "__float__", "__index__", "item",
    "tolist", "numpy", "__array__", "__repr__", "__str__", "__format__",
    "nonzero", "argwhere", "masked_select", "unique", "unique_consecutive",
    "equal", "allclose", "bincount", "histc"))
#: factories that make a tensor from host data
_FROM_HOST = frozenset(("tensor", "as_tensor", "asarray"))

def _is_mask(x) -> bool:
    if isinstance(x, (tuple, list)):
        return any(_is_mask(i) for i in x)
    return isinstance(x, torch.Tensor) and x.dtype in (torch.bool,
                                                       torch.uint8)


def _dev_type(dev) -> Optional[str]:
    return None if dev is None else torch.device(dev).type


def _host_work(func, args, kwargs):
    """Why a call cannot be captured, or None: it reads the card from
    the host, or copies between the host and the card."""
    name = getattr(func, "__name__", "")
    this = args[0] if args else None
    on_card = isinstance(this, torch.Tensor) and this.is_cuda
    if name in _HOST_READS and on_card:
        return f"{name} reads the card from the host"
    if name == "where" and len(args) == 1 and on_card:
        return "where(condition) reads the card from the host"
    if name in ("__getitem__", "__setitem__", "index_put", "index_put_") \
            and on_card and _is_mask(args[1] if len(args) > 1 else None):
        return f"{name} with a boolean mask reads the card"
    if name == "repeat_interleave" and on_card \
            and isinstance(args[1] if len(args) > 1 else None, torch.Tensor) \
            and kwargs.get("output_size") is None:
        return "repeat_interleave without output_size reads the card"
    if name in ("to", "cuda", "cpu", "copy_") \
            and isinstance(this, torch.Tensor):
        dst = None
        if name == "cuda":
            dst = "cuda"
        elif name == "cpu":
            dst = "cpu"
        elif name == "copy_" and len(args) > 1 \
                and isinstance(args[1], torch.Tensor):
            dst, src = this.device.type, args[1].device.type
            if (dst == "cpu") != (src == "cpu"):
                return "copy_ between the host and the card"
            return None
        else:
            for a in list(args[1:]) + [kwargs.get("device")]:
                if isinstance(a, (str, torch.device)):
                    dst = a
                elif isinstance(a, torch.Tensor):
                    dst = a.device
        if dst is not None and (this.device.type == "cpu") != \
                (_dev_type(dst) == "cpu"):
            return f"{name} copies between the host and the card"
    if name in _FROM_HOST and _dev_type(kwargs.get("device")) == "cuda" \
            and not (isinstance(this, torch.Tensor) and this.is_cuda):
        return f"{name} copies host data to the card"
    return None


class _HostWork(TorchFunctionMode):
    """Notes the first call a capture cannot hold (thread-local: it sees
    only the calling thread's calls, and costs no import)."""

    def __init__(self):
        super().__init__()
        self.found = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.found is None:
            self.found = _host_work(func, args, kwargs)
        return func(*args, **kwargs)


def _refusal(label: str, why: str) -> CaptureRefused:
    """A counted refusal."""
    REGISTRY.counter(
        "autotune_aot_errors_total",
        "failed program builds (graph captures refused)").inc()
    return CaptureRefused(f"{label}: {why}")


def _refuse(label: str, why: str, cause=None):
    raise _refusal(label, why) from cause


def screened_call(fn: Callable, *args, label: str = "call"):
    """``(result, refusal)``: ``fn(*args)`` run eagerly under the capture
    pre-screen, and a counted :class:`CaptureRefused` when it did work a
    CUDA graph cannot hold (else None).  The result is the eager call's,
    usable either way."""
    mode = _HostWork()
    with capture_screen() as marks, mode:
        out = fn(*args)
    why = mode.found
    if why is None and marks:
        why = marks[0]
    return out, (None if why is None else _refusal(label, why))


def check_capturable(fn: Callable, *args, label: str = "call"):
    """Run ``fn(*args)`` (eagerly, on whatever it is given) and return its
    result; raise :class:`CaptureRefused` (counted) when it did work a
    CUDA graph cannot hold.  The probe of a call about to be captured."""
    out, refusal = screened_call(fn, *args, label=label)
    if refusal is not None:
        raise refusal
    return out


#: the ladders' pools by id (``CompiledLadder.graph_pool``)
_LIVE_POOLS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
#: pools a failed capture left recording, and the failed graphs: kept
#: alive (freeing either while the allocator still records aborts the
#: process); a retired pool is never captured into again
_RETIRED_POOLS: dict = {}
_FAILED_GRAPHS: list = []


def _retire(dev, pool, graph) -> None:
    """A capture into ``pool`` failed: keep the graph and the pool alive,
    stop the allocator recording into the pool where it still does, and
    retire it."""
    _FAILED_GRAPHS.append(graph)
    if pool is None:
        return
    key = tuple(pool)
    if key in _RETIRED_POOLS:
        return
    _RETIRED_POOLS[key] = _LIVE_POOLS.get(key)
    for _ in range(4):
        try:
            torch._C._cuda_endAllocateToPool(dev.index, key)
        except Exception:   # no recording into the pool is left
            break


#: one side stream per device for every warm-up and capture (as
#: ``torch.cuda.graph`` keeps one): each stream a capture runs on keeps a
#: cuBLAS workspace of its own for the life of the process
_SIDE_STREAMS: dict = {}
#: one capture at a time on a side stream
_CAPTURE_LOCK = threading.RLock()


def _side_stream(dev) -> "torch.cuda.Stream":
    key = torch.device(dev).index
    with _CAPTURE_LOCK:
        if key not in _SIDE_STREAMS:
            _SIDE_STREAMS[key] = torch.cuda.Stream(dev)
        return _SIDE_STREAMS[key]


def _anchor_graph(pool) -> "torch.cuda.CUDAGraph":
    """A one-kernel graph captured into ``pool``, kept by the pool's
    owner so that the pool always has a live graph (not a program build:
    it is not counted)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    graph = torch.cuda.CUDAGraph()
    with _CAPTURE_LOCK:
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            graph.anchor = torch.zeros(1, device=dev)
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
    return graph


def _is_refusal(err: BaseException) -> bool:
    """A capture refusal, not a fault of the card: the error's first line
    (the CUDA error itself; the lines after it are PyTorch's hints, which
    name device-side assertions whatever the error) names the capture,
    and no sticky CUDA error."""
    from ..resilience.retry import STICKY_CUDA_MARKERS
    lines = str(err).strip().lower().splitlines()
    first = lines[0] if lines else ""
    if any(m in first for m in STICKY_CUDA_MARKERS):
        return False
    return "captur" in first


class _Graph:
    """One call of ``fn`` captured for one argument spec."""

    def __init__(self, fn: Callable, leaves: list, treedef, donated,
                 pool, label: str, warmup: bool = True):
        with _CAPTURE_LOCK:
            self._capture(fn, leaves, treedef, donated, pool, label, warmup)

    def _capture(self, fn, leaves, treedef, donated, pool, label, warmup):
        dev = _card_device(leaves)
        pool = pool() if callable(pool) else pool
        self.treedef = treedef
        self.keys = [_leaf_key(x) for x in leaves]
        self.label = label
        t0 = time.perf_counter()
        counts0 = {k: r() for k, (r, _) in _LAUNCH_COUNTERS.items()}
        # warm-up on scratch: the run's tensors and generator untouched;
        # lazy set-up (library handles, kernel builds) happens here, not
        # inside the capture
        warm = []
        for x in (leaves if warmup else ()):
            if isinstance(x, torch.Tensor):
                warm.append(x.clone())
            elif isinstance(x, TensorSpec):
                warm.append(torch.zeros(x.shape, dtype=x.dtype,
                                        device=x.device))
            elif isinstance(x, torch.Generator):
                warm.append(_clone_generator(x))
            else:
                warm.append(x)
        side = _side_stream(dev)
        if warmup:
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                check_capturable(fn, *_unflatten(warm, treedef), label=label)
            torch.cuda.current_stream(dev).wait_stream(side)
            side.synchronize()
        del warm
        counts1 = {k: r() for k, (r, _) in _LAUNCH_COUNTERS.items()}
        # static inputs: a donated tensor is its own; a spec leaf gets a
        # zero buffer; another tensor a buffer its calls are copied into
        self.static, self.gens, self.tensors = [], [], []
        self.mutable = set()
        #: leaf -> (weakref, version) of the tensor last copied in
        self._fed = {}
        for i, x in enumerate(leaves):
            if isinstance(x, torch.Tensor) and i in donated:
                st = x
            elif isinstance(x, TensorSpec):
                st = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
            elif isinstance(x, torch.Tensor):
                st = torch.empty_like(x)
                st.copy_(x)
                self._fed[i] = (weakref.ref(x), x._version)
            elif isinstance(x, torch.Generator):
                st = torch.Generator(device=x.device)
                self.gens.append((i, st))
            else:
                st = x
            if isinstance(st, torch.Tensor):
                self.tensors.append(i)
            self.static.append(st)
        versions = {i: self.static[i]._version for i in self.tensors}
        graph = torch.cuda.CUDAGraph()
        for _, g in self.gens:
            graph.register_generator_state(g)
        failure, ended = None, True
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.out = fn(*_unflatten(self.static, treedef))
            except Exception as err:
                failure = err
            try:
                graph.capture_end()
            except Exception as err:
                # the call's own error says why (the end only reports the
                # capture it invalidated)
                failure, ended = failure or err, False
        torch.cuda.current_stream(dev).wait_stream(side)
        if failure is not None:
            self._restore_counts(counts0)
            if not ended:
                # an invalidated capture leaves the allocator recording
                _retire(dev, pool, graph)
            if not _is_refusal(failure):
                raise failure
            _refuse(label, str(failure), failure)
        self.graph = graph
        # a static input the call wrote to: copied back to a caller's
        # tensor that is not the static one
        self.mutable = {i for i in self.tensors
                        if self.static[i]._version != versions[i]}
        counts2 = {k: r() for k, (r, _) in _LAUNCH_COUNTERS.items()}
        #: launches of each registered kernel per replay
        self.launches = {k: counts2[k] - counts1[k] for k in counts2}
        self._restore_counts(counts0)
        self.seconds = time.perf_counter() - t0
        record_build(self.seconds)

    @staticmethod
    def _restore_counts(counts0: dict):
        for k, (read, add) in _LAUNCH_COUNTERS.items():
            add(counts0.get(k, 0) - read(), False)

    def matches(self, leaves: list, treedef) -> bool:
        """Whether a call's args have this graph's spec."""
        if len(leaves) != len(self.keys) or treedef != self.treedef:
            return False
        for i, x in enumerate(leaves):
            if x is self.static[i]:
                continue
            fed = self._fed.get(i)
            if fed is not None and fed[0]() is x:
                continue
            if _leaf_key(x) != self.keys[i]:
                return False
        return True

    def inputs(self) -> tuple:
        """The static inputs in the shape of the call's args (a
        generator leaf is the graph's own)."""
        return _unflatten(self.static, self.treedef)

    def replay(self, leaves: list):
        for i in self.tensors:
            x, st = leaves[i], self.static[i]
            if x is st:
                continue
            fed = self._fed.get(i)
            if fed is not None and fed[0]() is x and fed[1] == x._version:
                continue
            st.copy_(x)
            self._fed[i] = (weakref.ref(x), x._version)
        for i, g in self.gens:
            g.set_state(leaves[i].get_state())
        self.graph.replay()
        for i, g in self.gens:
            leaves[i].set_state(g.get_state())
        for i in self.mutable:
            x = leaves[i]
            if x is not self.static[i]:
                x.copy_(self.static[i])
                self._fed[i] = (weakref.ref(x), x._version)
        for k, n in self.launches.items():
            if n:
                _LAUNCH_COUNTERS[k][1](n, True)
        return self.out


class _Direct:
    """The CPU's stand-in for a captured call: ``fn`` itself, called for
    the spec it was made for."""

    def __init__(self, fn: Callable, leaves: list, treedef):
        self.fn = fn
        self.treedef = treedef
        self.keys = [_leaf_key(x) for x in leaves]
        self.static = [torch.zeros(x.shape, dtype=x.dtype, device=x.device)
                       if isinstance(x, TensorSpec) else x for x in leaves]
        self.seconds = 0.0

    def matches(self, leaves: list, treedef) -> bool:
        return (len(leaves) == len(self.keys) and treedef == self.treedef
                and all(_leaf_key(x) == k
                        for x, k in zip(leaves, self.keys)))

    def inputs(self) -> tuple:
        return _unflatten(self.static, self.treedef)

    def replay(self, leaves: list):
        return self.fn(*_unflatten(leaves, self.treedef))


class _Jitted:
    """A function that captures lazily on the card: one graph per
    argument spec (``jax.jit``'s cache); on the CPU, the function."""

    def __init__(self, fn: Callable, donate_argnums=(), pool=None,
                 label: Optional[str] = None, warmup: bool = True,
                 donate_keys=()):
        self.fn = fn
        self.donate_argnums = tuple(donate_argnums)
        self.donate_keys = tuple(donate_keys)
        self.pool = pool
        self.warmup = bool(warmup)
        self.label = label or getattr(fn, "__qualname__", repr(fn))
        self._graphs: list = []
        self._lock = threading.Lock()

    def capture(self, leaves: list, treedef, donated) -> _Graph:
        """Capture ``fn`` for these leaves (a ``compile.capture`` span)."""
        with _spans.span("compile.capture", key=self.label):
            return _Graph(self.fn, leaves, treedef, donated, self.pool,
                          self.label, warmup=self.warmup)

    def __call__(self, *args):
        leaves, treedef, donated = _flatten(args, self.donate_argnums,
                                            self.donate_keys)
        if _card_device(leaves) is None:
            return self.fn(*args)
        with self._lock:
            graph = next((g for g in reversed(self._graphs)
                          if g.matches(leaves, treedef)), None)
            if graph is None:
                graph = self.capture(leaves, treedef, donated)
                self._graphs.append(graph)
        return graph.replay(leaves)

    @property
    def graphs(self) -> int:
        """Graphs captured so far."""
        return len(self._graphs)


def jit_compile(fn=None, *, donate_argnums=(), pool=None,
                label: Optional[str] = None, warmup: bool = True,
                donate_keys=()):
    """``fn`` captured lazily as a CUDA graph, one per argument spec
    (``pool``: the graph memory pool to capture into, or a callable that
    gives it at each capture, as :meth:`CompiledLadder.graph_pool` does;
    ``donate_argnums``: the arguments whose tensors are the graph's own
    inputs, updated in place; ``donate_keys``: dict keys whose tensors, in
    any argument, are its own inputs too; ``warmup=False``: the caller ran
    the call under :func:`check_capturable` on scratch, which stands for
    the warm-up).  Called with no CUDA tensor it calls ``fn``.  Usable as
    a decorator."""
    if fn is None:
        return lambda f: jit_compile(f, donate_argnums=donate_argnums,
                                     pool=pool, label=label, warmup=warmup,
                                     donate_keys=donate_keys)
    return _Jitted(fn, donate_argnums=donate_argnums, pool=pool, label=label,
                   warmup=warmup, donate_keys=donate_keys)


class AotGuard:
    """A call captured ahead of time, with a lazy escape hatch: a call
    whose args drifted from the captured spec counts
    ``autotune_aot_signature_misses_total`` and goes through the
    ``jit_compile`` wrapper, which captures for the new spec."""

    __slots__ = ("_compiled", "_fallback", "_avals", "captures")

    def __init__(self, compiled, fallback: _Jitted, avals=None):
        self._compiled = compiled
        self._fallback = fallback
        self._avals = avals
        #: captures of the guard's program (1, +1 for each that
        #: :meth:`specialize` made)
        self.captures = 1

    def __call__(self, *args):
        leaves, treedef, _ = _flatten(args)
        if self._compiled.matches(leaves, treedef):
            return self._compiled.replay(leaves)
        REGISTRY.counter(
            "autotune_aot_signature_misses_total",
            "AOT programs bypassed by spec drift").inc()
        return self._fallback(*args)

    def specialize(self, *args):
        """Capture again for the specs of ``args`` when they drifted from
        the captured ones (the donated arguments' tensors become the new
        graph's own); a no-op otherwise."""
        leaves, treedef, donated = _flatten(
            args, self._fallback.donate_argnums, self._fallback.donate_keys)
        if self._compiled.matches(leaves, treedef):
            return
        self._compiled = _build_compiled(self._fallback, leaves, treedef,
                                         donated)
        self._avals = avals_like(args)
        self.captures += 1

    @property
    def inputs(self) -> tuple:
        """The captured call's static inputs, in the shape of its args: a
        spec argument's buffers are the graph's own, for a caller that
        keeps them as its state."""
        return self._compiled.inputs()

    @property
    def capture_seconds(self) -> float:
        """Seconds the capture took, its warm-up included (0 on the
        CPU)."""
        return self._compiled.seconds

    @property
    def captured(self) -> bool:
        """Whether a CUDA graph serves the captured spec."""
        return isinstance(self._compiled, _Graph)


def _build_compiled(jitted: _Jitted, leaves, treedef, donated):
    if _card_device(leaves) is None:
        return _Direct(jitted.fn, leaves, treedef)
    return jitted.capture(leaves, treedef, donated)


def aot_compile(fn, *arg_specs, donate_argnums=None, pool=None):
    """Capture ``fn`` ahead of time for ``arg_specs`` (spec leaves get
    buffers of their own; tensor leaves give the warm-up its values; a
    donated argument's tensors are the graph's own) and return the
    :class:`AotGuard` that replays it.  ``fn`` is a :func:`jit_compile`
    wrapper (its donation and pool apply) or a plain function.  On the
    CPU the guard calls ``fn``.  As in the JAX package, the capture does
    not fill the wrapper's own cache."""
    jitted = fn if isinstance(fn, _Jitted) else jit_compile(
        fn, donate_argnums=donate_argnums or (), pool=pool)
    donate = (jitted.donate_argnums if donate_argnums is None
              else tuple(donate_argnums))
    leaves, treedef, donated = _flatten(arg_specs, donate,
                                        jitted.donate_keys)
    return AotGuard(_build_compiled(jitted, leaves, treedef, donated),
                    jitted, avals=avals_like(arg_specs))


class CompiledLadder:
    """Bounded LRU of built programs with single-flight builds and a
    background prewarm worker.

    ``get(key, build)`` returns the cached program, or builds it on the
    calling thread (a ``compile.miss`` span); if the same key is already
    building, it waits for that build.  ``prewarm(key, build)`` enqueues
    the build on the daemon worker (a ``compile.aot`` span); cached and
    in-flight keys are dropped.  A failed prewarm is counted and logged,
    never raised: the eventual ``get`` builds synchronously.
    """

    def __init__(self, capacity: int = 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        self.capacity = int(capacity)
        self._cache: "OrderedDict" = OrderedDict()
        self._lock = threading.RLock()
        self._inflight: dict = {}        # key -> threading.Event
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._pool = None
        self._anchor = None
        install_compile_listener()

    # ---- introspection ---------------------------------------------------

    def __len__(self):
        with self._lock:
            return len(self._cache)

    def __contains__(self, key):
        with self._lock:
            return key in self._cache

    def keys(self):
        with self._lock:
            return list(self._cache)

    def clear(self):
        with self._lock:
            self._cache.clear()

    def drop_pool(self):
        """Let go of the graph pool (its memory returns to the card once
        no graph of it is left); a later capture makes a new one."""
        with self._lock:
            if self._pool is not None \
                    and tuple(self._pool.id) not in _RETIRED_POOLS:
                self._pool = self._anchor = None

    def summary(self) -> dict:
        """Hits (a warm program served without a build), misses
        (synchronous builds on the calling thread), evictions, occupancy
        and capacity."""
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "size": len(self._cache),
                "capacity": self.capacity,
            }

    # ---- the graph pool ----------------------------------------------------

    def graph_pool(self):
        """The id of the memory pool every CUDA graph of this ladder
        captures into (a ``torch.cuda.MemPool`` made on first use): the
        ladder's entries share one round-sized pool instead of holding
        one each.  The ladder holds the pool and a one-kernel graph
        captured into it, so the pool outlives any one program's graphs
        (a refused capture's, an evicted entry's): PyTorch cannot capture
        into a pool whose graphs have all been freed."""
        with self._lock:
            if self._pool is None or tuple(self._pool.id) in _RETIRED_POOLS:
                self._pool = torch.cuda.MemPool()
                _LIVE_POOLS[tuple(self._pool.id)] = self._pool
                self._anchor = _anchor_graph(self._pool.id)
            return self._pool.id

    def pool_source(self) -> Callable:
        """A callable giving :meth:`graph_pool` at each capture, for the
        programs this ladder holds: it refers to the ladder weakly, so an
        entry's graphs do not keep the ladder, and the memory of every
        entry, alive after the sampler is gone."""
        ref = weakref.ref(self)

        def pool():
            ladder = ref()
            return None if ladder is None else ladder.graph_pool()
        return pool

    def pool_bytes(self) -> dict:
        """``reserved`` and ``allocated`` bytes of the graph pool, from
        the caching allocator's segments of that pool (zeros before the
        first capture)."""
        with self._lock:
            pool = self._pool
        out = {"reserved": 0, "allocated": 0}
        if pool is None:
            return out
        for seg in torch.cuda.memory_snapshot():
            if tuple(seg.get("segment_pool_id") or ()) == tuple(pool.id):
                out["reserved"] += int(seg["total_size"])
                out["allocated"] += int(seg["allocated_size"])
        return out

    # ---- core ------------------------------------------------------------

    def _insert(self, key, value):
        with self._lock:
            self._cache[key] = value
            self._cache.move_to_end(key)
            while len(self._cache) > self.capacity:
                evicted, _ = self._cache.popitem(last=False)
                self._count_eviction(evicted)

    def _count_eviction(self, key):
        self._evictions += 1
        REGISTRY.counter(
            "autotune_ladder_evictions_total",
            "built programs dropped by the ladder LRU").inc()
        logger.info("ladder evicted %r (capacity %d)", key, self.capacity)

    def get(self, key, build: Callable):
        """Serve ``key``, building on this thread on a miss; waits for an
        in-flight build of the same key rather than duplicating it."""
        while True:
            with self._lock:
                if key in self._cache:
                    self._cache.move_to_end(key)
                    self._hits += 1
                    REGISTRY.counter(
                        "autotune_ladder_hits_total",
                        "warm programs served by the ladder").inc()
                    return self._cache[key]
                ev = self._inflight.get(key)
                if ev is None:
                    ev = self._inflight[key] = threading.Event()
                    owner = True
                else:
                    owner = False
            if not owner:
                ev.wait()
                continue  # built (or failed: then this thread owns it)
            try:
                with _spans.span("compile.miss", key=str(key)):
                    value = _timed_build(build)
                with self._lock:
                    self._misses += 1
                REGISTRY.counter(
                    "autotune_compile_misses_total",
                    "synchronous ladder builds").inc()
                self._insert(key, value)
                return value
            finally:
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()

    def prewarm(self, key, build: Callable) -> bool:
        """Schedule a background build of ``key``; True when enqueued
        (False: cached or already in flight)."""
        with self._lock:
            if key in self._cache or key in self._inflight:
                return False
            self._inflight[key] = threading.Event()
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._worker_loop,
                    name="pyabc-tpu-torch-prewarm", daemon=True)
                self._worker.start()
        self._queue.put((key, build))
        return True

    def retain(self, match: Callable, keep: int) -> None:
        """Evict the least recently used entries whose key satisfies
        ``match`` beyond the ``keep`` most recent (each eviction counted
        as the LRU's are)."""
        with self._lock:
            matching = [k for k in self._cache if match(k)]
            for key in matching[:max(len(matching) - int(keep), 0)]:
                del self._cache[key]
                self._count_eviction(key)

    def _worker_loop(self):
        while True:
            key, build = self._queue.get()
            try:
                with _spans.span("compile.aot", key=str(key)):
                    value = _timed_build(build)
                REGISTRY.counter(
                    "autotune_aot_builds_total",
                    "background program prewarms").inc()
                self._insert(key, value)
            except Exception:
                REGISTRY.counter(
                    "autotune_aot_errors_total",
                    "failed background program builds").inc()
                logger.warning("prewarm of %r failed (the program is "
                               "built on demand)", key, exc_info=True)
            finally:
                with self._lock:
                    ev = self._inflight.pop(key, None)
                if ev is not None:
                    ev.set()
                self._queue.task_done()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every scheduled prewarm has finished; False on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                events = list(self._inflight.values())
            if not events:
                return True
            for ev in events:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                ev.wait(remaining)
