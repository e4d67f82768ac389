"""PS101 positive fixture (torch twin of tests/analysis_fixtures/
ps101_bad.py): torch.compile inside a plain function — neither module
level, nor under a cache decorator, nor returned to a caller."""
import torch


def handler(x):
    fn = torch.compile(lambda v: v * 2)
    return fn(x)
