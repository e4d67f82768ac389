"""K1: the fused k-step local update (counterpart of
kafka_ps_tpu/ops/fused_update.py:local_update and its Pallas `_kernel`).

`local_update(theta, x, y, mask, *, cfg)` → (delta, loss at the updated
parameters), the contract of models/logreg.local_update.  For CUDA
tensors it launches the hand-written kernel in `csrc/local_update.cu`
(built by `_build` on first use) or raises; for CPU tensors it runs
`local_update_plain`, the loop of models/logreg on tensors.  There is no
fallback from the card to the plain version.

`launches` counts the kernel's invocations (one per call, each call is
2k+2 CUDA launches — see the note in the .cu file), so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from kafka_ps_tpu_torch.models import logreg
from kafka_ps_tpu_torch.ops import _build
from kafka_ps_tpu_torch.utils.config import ModelConfig

SOURCE = "local_update.cu"
MAX_ROWS = 16          # classes + 1 the kernel takes (kMaxRows in the .cu)
ROWS_PER_CTA = 32      # batch rows per CTA (kRowsPerCta in the .cu)

launches = 0
_lock = threading.Lock()


def local_update_plain(theta: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, mask: torch.Tensor, *,
                       cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: k gradient steps as a Python
    loop, then the loss at the updated parameters."""
    return logreg.local_update(theta, x, y, mask, cfg=cfg)


def check_args(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor, cfg: ModelConfig) -> None:
    """What the kernel takes: float32 theta/x/mask and int32 labels, all
    contiguous, on one device, shaped by cfg.  Raises otherwise."""
    if cfg.num_rows > MAX_ROWS:
        raise ValueError(f"local_update kernel takes at most {MAX_ROWS - 1} "
                         f"classes, got {cfg.num_classes}")
    for name, t, dtype in (("theta", theta, torch.float32),
                           ("x", x, torch.float32),
                           ("y", y, torch.int32),
                           ("mask", mask, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    batch = x.shape[0]
    if x.ndim != 2 or x.shape[1] != cfg.num_features or batch < 1:
        raise ValueError(f"x must be [B>=1, {cfg.num_features}], "
                         f"got {tuple(x.shape)}")
    if tuple(theta.shape) != (cfg.num_params,):
        raise ValueError(f"theta must be [{cfg.num_params}], "
                         f"got {tuple(theta.shape)}")
    if tuple(y.shape) != (batch,) or tuple(mask.shape) != (batch,):
        raise ValueError(f"y and mask must be [{batch}], got "
                         f"{tuple(y.shape)} and {tuple(mask.shape)}")


_fn = None


def _kernel_fn():
    """The C entry point, with its signature declared and the scratch
    geometry checked against the compiled source."""
    global _fn
    with _lock:
        if _fn is None:
            lib = _build.load(SOURCE)
            if (lib.kps_rows_per_cta() != ROWS_PER_CTA
                    or lib.kps_max_rows() != MAX_ROWS):
                raise RuntimeError(f"{SOURCE} disagrees with "
                                   "fused_update.py on ROWS_PER_CTA / "
                                   "MAX_ROWS")
            fn = lib.kps_local_update
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def _launch(theta, x, y, mask, cfg: ModelConfig):
    global launches
    fn = _kernel_fn()
    batch, features = x.shape
    nblk = -(-batch // ROWS_PER_CTA)
    P = cfg.num_params
    dev = x.device
    delta = torch.empty(P, dtype=torch.float32, device=dev)
    loss = torch.empty(1, dtype=torch.float32, device=dev)
    w = torch.empty(P, dtype=torch.float32, device=dev)
    partials = torch.empty((nblk, P), dtype=torch.float32, device=dev)
    loss_partials = torch.empty(nblk, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(theta.data_ptr(), x.data_ptr(), y.data_ptr(),
                 mask.data_ptr(), delta.data_ptr(), loss.data_ptr(),
                 w.data_ptr(), partials.data_ptr(),
                 loss_partials.data_ptr(), batch, features, cfg.num_rows,
                 cfg.num_max_iter, cfg.local_learning_rate, stream)
    if err != 0:
        raise RuntimeError(f"local_update kernel launch failed: CUDA error "
                           f"{err}")
    with _lock:
        launches += 1
    return delta, loss[0]


def local_update(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 mask: torch.Tensor, *, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """k local solver steps on the buffer → (delta, loss at the updated
    parameters).  CUDA tensors go to the kernel, CPU tensors to the plain
    version; arguments are checked first either way."""
    check_args(theta, x, y, mask, cfg)
    if x.device.type == "cuda":
        return _launch(theta, x, y, mask, cfg)
    return local_update_plain(theta, x, y, mask, cfg=cfg)
