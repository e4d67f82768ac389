"""PS101 positive fixture: a class whose __init__ captures a CUDA graph
is constructed inside a handler — a capture per call."""
import torch


class _Graph:
    def __init__(self, fn, x):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(x)


def step(fn, x):
    g = _Graph(fn, x)
    g.graph.replay()
    return g.out
