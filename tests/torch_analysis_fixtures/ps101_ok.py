"""PS101 negative fixture (torch twin): every sanctioned build site of
a compiled program, a CUDA graph or a kernel library."""
import ctypes
import functools

import torch

double = torch.compile(lambda v: v * 2)       # module level
_libs = {}


@functools.lru_cache(maxsize=None)
def cached_builder(n):
    return torch.compile(lambda v: v * n)     # keyed-cache site


def factory(scale):
    fn = torch.compile(lambda v: v * scale)   # factory: caller owns caching
    return fn


def load(name):
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(name)               # stored in a keyed cache
        _libs[name] = lib
    return lib


class _Graph:
    """Captures one graph at construction: built where it is built."""

    def __init__(self, fn, x):
        self.graph = torch.cuda.CUDAGraph()   # instance cache site
        with torch.cuda.graph(self.graph):
            self.out = fn(x)


class Steps:
    def __init__(self, fn):
        self.fn = fn
        self._graphs = {}

    def __call__(self, x):
        key = tuple(x.shape)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _Graph(self.fn, x)   # keyed cache
        graph.graph.replay()
        return graph.out
