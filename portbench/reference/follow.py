"""What of the weights the check follows.

The check snapshots the program's weights after each set-up round and
after the checked call; a family follows the whole flat vector, or only
the positions of it that its rounds can move (a sparse family: the rows
its buffers can touch and its dense leaves).  The family's reference
works on that same part, which `take` cuts from its own weights.
"""

from __future__ import annotations

import numpy as np
import torch


class Follow:
    """The whole flat vector (`index` None), or the positions `index` of
    it, in that order."""

    def __init__(self, index: torch.Tensor | None = None):
        self.index = index

    def take(self, theta: torch.Tensor) -> torch.Tensor:
        if self.index is None:
            return theta
        return theta[self.index.to(theta.device)]

    def snapshot(self, theta: torch.Tensor) -> np.ndarray:
        """The followed part of the program's weights, copied to the
        host: the only copy of them the harness keeps."""
        return self.take(theta.detach()).float().cpu().numpy().copy()
