"""Per-worker error-feedback compression of gradient deltas (counterpart
of kafka_ps_tpu/compress/feedback.py).

Lossy codecs alone bias SGD: the dropped or rounded part of every delta
is gone.  Error feedback (Seide et al. 2014; Karimireddy et al. 2019)
keeps the quantization error as a residual and folds it into the next
delta, so the compressed stream sums to the uncompressed one up to one
in-flight residual.

The residual is worker state: it rides through utils/checkpoint.py (key
``ef{worker}_residual``) so a resumed run continues with the exact
residual it stopped with.
"""

from __future__ import annotations

import numpy as np
import torch

from kafka_ps_tpu_torch.compress.codecs import Codec
from kafka_ps_tpu_torch.utils.config import resolve_device


class ErrorFeedback:
    """Gradient-side compressor for ONE logical worker (residuals are
    per stream: mixing two workers' errors would re-introduce the bias
    error feedback exists to cancel).  `device` follows
    utils.config.resolve_device."""

    def __init__(self, codec: Codec, device=None):
        self.codec = codec
        self.device = resolve_device(device)
        self.residual = torch.zeros((codec.n,), dtype=torch.float32,
                                    device=self.device)

    def step(self, delta):
        """delta -> (decoded_delta, EncodedValues) to send; the residual
        (delta + residual - decoded) carries to the next call.  The
        residual is REPLACED, never written in place: a checkpoint taken
        on another thread reads the old tensor or the new one, whole."""
        decoded, self.residual, parts = self.codec.ef_step(
            delta, self.residual)
        return decoded, self.codec.encoded(parts)

    # -- checkpoint plumbing (utils/checkpoint.py) --------------------------

    def state(self) -> np.ndarray:
        """The residual as a host float32 array (a copy)."""
        return self.residual.detach().cpu().numpy().astype(np.float32,
                                                           copy=True)

    def restore(self, arr) -> None:
        self.residual = torch.tensor(np.asarray(arr, dtype=np.float32),
                                     device=self.device)
