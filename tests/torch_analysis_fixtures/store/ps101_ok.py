"""PS101 negative fixture (store/ path, torch twin): the page apply is
compiled at module level; bucketed shapes come from a keyed cache."""
import functools

import torch

apply_page = torch.compile(lambda t, d: t + d)     # module level


@functools.lru_cache(maxsize=None)
def bucketed_apply(bucket):
    return torch.compile(lambda t, d: t + d)       # keyed-cache site
