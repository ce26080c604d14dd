"""One executable CUDA graph of a decode batch's prefix and loop, with the
loop's exit test on the device (``csrc/graph_loop.cu``): the counterpart
of JAX's ``lax.while_loop`` inside one compiled program.

:class:`GraphLoop` assembles the graph out of PyTorch captures, taken with
``torch.cuda.CUDAGraph(keep_graph=True)`` and never instantiated by
PyTorch: :meth:`~GraphLoop.run` adds a capture as a child graph node,
:meth:`~GraphLoop.repeat` adds a capture as the body of a WHILE or an IF
node whose condition a one-thread kernel sets from a flag and the
position that the programs leave on the device. :meth:`~GraphLoop.launch`
launches the whole graph on the current stream, once a batch, and counts
it in :data:`LAUNCHES`.

:class:`HostLoop` runs the same structure on the host, the programs as
they are and each test read from the tensors: the CPU's loop, which the
CPU tests hold to the eager loop and to JAX.

Every failure raises: nothing falls back to a host-driven loop. The
library is built at first use, like the kernels (``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Tuple

import torch

from mtn_tpu_torch.ops._build import NVCC_FLAGS, Library, nvcc_path

LAUNCHES = 0   # graph launches of every GraphLoop


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.mtn_gl_error.argtypes = [i]
    lib.mtn_gl_error.restype = ctypes.c_char_p
    lib.mtn_gl_create.argtypes = [pp]
    lib.mtn_gl_destroy.argtypes = [p, p]
    lib.mtn_gl_add_child.argtypes = [p, p, p, pp]
    lib.mtn_gl_handle.argtypes = [p, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.mtn_gl_add_test.argtypes = [p, p, ctypes.c_ulonglong, p, i, p, ll,
                                    pp]
    lib.mtn_gl_add_conditional.argtypes = [p, p, ctypes.c_ulonglong, i, pp,
                                           pp]
    lib.mtn_gl_instantiate.argtypes = [p, pp, ctypes.POINTER(ctypes.c_int)]
    lib.mtn_gl_launch.argtypes = [p, p]
    for name in ("create", "destroy", "add_child", "handle", "add_test",
                 "add_conditional", "instantiate", "launch"):
        getattr(lib, f"mtn_gl_{name}").restype = ctypes.c_int


LIBRARY = Library("graph_loop", _bind, ".cu", nvcc_path, NVCC_FLAGS)


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"graph loop: {what}: CUDA error {rc} "
                           f"({lib.mtn_gl_error(rc).decode()})")


def _flag_bytes(flag: torch.Tensor) -> int:
    if flag.dtype not in (torch.bool, torch.int64) or flag.numel() != 1:
        raise ValueError(f"a loop's flag is one bool or int64, got "
                         f"{flag.dtype} {tuple(flag.shape)}")
    return flag.element_size()


def _position(l: torch.Tensor) -> None:
    if l.dtype != torch.int64 or l.numel() != 1:
        raise ValueError(f"a loop's position is one int64, got {l.dtype} "
                         f"{tuple(l.shape)}")


class GraphLoop:
    """One parent CUDA graph, built node after node in a chain: each
    node depends on the one added before it in the same graph. The
    captures it copies (``torch.cuda.CUDAGraph`` objects made with
    ``keep_graph=True``) and the tensors its tests read must outlive
    it."""

    def __init__(self):
        self.lib = LIBRARY.lib()
        graph = ctypes.c_void_p()
        _check(self.lib, self.lib.mtn_gl_create(ctypes.byref(graph)),
               "cudaGraphCreate")
        self.graph, self.exec = graph.value, None
        self._last = {self.graph: None}   # the chain's end, by graph

    def _node(self, graph, fn, *args) -> None:
        node = ctypes.c_void_p()
        _check(self.lib, fn(graph, self._last[graph], *args,
                            ctypes.byref(node)), fn.__name__)
        self._last[graph] = node.value

    def run(self, capture: torch.cuda.CUDAGraph, graph=None) -> None:
        """``capture`` as a child graph node of ``graph`` (the parent by
        default)."""
        graph = graph or self.graph
        self._node(graph, self.lib.mtn_gl_add_child,
                   ctypes.c_void_p(capture.raw_cuda_graph()))

    def _test(self, graph, handle: int, flag: torch.Tensor,
              l: torch.Tensor, limit: int) -> None:
        self._node(graph, self.lib.mtn_gl_add_test, handle,
                   ctypes.c_void_p(flag.data_ptr()), _flag_bytes(flag),
                   ctypes.c_void_p(l.data_ptr()), limit)

    def repeat(self, body: torch.cuda.CUDAGraph, flag: torch.Tensor,
               l: torch.Tensor, limit: int, once: bool = False) -> None:
        """``body`` while ``flag != 0 and l <= limit`` (with ``once``, if
        it holds): a test node, then a WHILE (IF) node whose body is the
        capture, followed in a WHILE body by the test again."""
        _position(l)
        handle = ctypes.c_ulonglong()
        _check(self.lib, self.lib.mtn_gl_handle(self.graph,
                                                ctypes.byref(handle)),
               "cudaGraphConditionalHandleCreate")
        self._test(self.graph, handle.value, flag, l, limit)
        node, inner = ctypes.c_void_p(), ctypes.c_void_p()
        _check(self.lib, self.lib.mtn_gl_add_conditional(
            self.graph, self._last[self.graph], handle.value,
            0 if once else 1, ctypes.byref(node), ctypes.byref(inner)),
            "cudaGraphAddNode (conditional)")
        self._last[self.graph] = node.value
        self._last[inner.value] = None
        self.run(body, inner.value)
        if not once:
            self._test(inner.value, handle.value, flag, l, limit)

    def instantiate(self) -> None:
        exec_, result = ctypes.c_void_p(), ctypes.c_int()
        rc = self.lib.mtn_gl_instantiate(self.graph, ctypes.byref(exec_),
                                         ctypes.byref(result))
        _check(self.lib, rc, f"cudaGraphInstantiateWithParams (result "
                             f"{result.value})")
        self.exec = exec_.value

    def launch(self) -> None:
        """One launch of the whole graph on the current stream."""
        global LAUNCHES
        if self.exec is None:
            self.instantiate()
        _check(self.lib, self.lib.mtn_gl_launch(
            self.exec, ctypes.c_void_p(torch.cuda.current_stream()
                                       .cuda_stream)), "cudaGraphLaunch")
        LAUNCHES += 1

    def close(self) -> None:
        if self.graph is not None:
            graph, exec_, self.graph, self.exec = self.graph, self.exec, \
                None, None
            _check(self.lib, self.lib.mtn_gl_destroy(graph, exec_),
                   "cudaGraphDestroy")

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the context may be gone
            pass


class HostLoop:
    """:class:`GraphLoop`'s structure on the host: :meth:`run` and
    :meth:`repeat` take functions, and :meth:`repeat` the flag and the
    position as functions that return them (a CPU program set's prefix
    makes them anew); :meth:`launch` runs the functions in order, each
    test read from the tensors (``reads`` counts the reads,
    ``iterations`` each repeated function's runs in the last launch)."""

    def __init__(self):
        self.nodes: List[Tuple[Callable[[], None], Optional[tuple]]] = []
        self.reads = 0
        self.iterations: List[int] = []

    def run(self, fn: Callable[[], None]) -> None:
        self.nodes.append((fn, None))

    def repeat(self, fn: Callable[[], None],
               flag: Callable[[], torch.Tensor],
               l: Callable[[], torch.Tensor], limit: int,
               once: bool = False) -> None:
        self.nodes.append((fn, (flag, l, limit, once)))

    def _test(self, flag, l, limit) -> bool:
        """``loop_test`` of ``csrc/graph_loop.cu``, read on the host."""
        f, pos = flag(), l()
        _flag_bytes(f)
        _position(pos)
        self.reads += 1
        return bool(f.reshape(()).item()) and int(pos.item()) <= limit

    def launch(self) -> None:
        self.iterations = []
        for fn, test in self.nodes:
            if test is None:
                fn()
                continue
            flag, l, limit, once = test
            n = 0
            while self._test(flag, l, limit):
                fn()
                n += 1
                if once:
                    break
            self.iterations.append(n)
