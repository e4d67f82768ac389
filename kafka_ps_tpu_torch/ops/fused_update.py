"""The fused k-step local updates (counterpart of
kafka_ps_tpu/ops/fused_update.py), one wrapper per TPU kernel:

  K1 `local_update`              logreg, one worker   (`_kernel`)
  K2 `local_update_batched`      logreg, a gang       (grid over members)
  K4 `mlp_local_update`          MLP, one worker      (`_mlp_kernel`)
  K6 `mlp_local_update_batched`  MLP, a gang          (grid over members)

Each returns (delta, loss at the updated parameters), the contract of the
task's local update; the batched ones take per-member sequences (or
stacked tensors) and return (deltas [k, P], losses [k]).  For CUDA
tensors a wrapper launches its hand-written kernel (`csrc/local_update.cu`
for K1/K2, `csrc/mlp_update.cu` for K4/K6, built by `_build` on first use)
or raises; for CPU tensors it runs the kernel's plain PyTorch version
beside it.  There is no fallback from the card to the plain version.

K1 is the K2 kernel with one member, and K4 the K6 kernel with one
member, so a gang member is bitwise equal to a single call on its inputs
by construction; the plain batched versions are loops of the plain
single versions, so the same holds on the CPU.

The counters count each wrapper's kernel calls (a call is several CUDA
launches — see the .cu files), so a run can show that its main path went
through the kernels: `launches` (K1), `batched_launches` (K2),
`mlp_launches` (K4), `mlp_batched_launches` (K6), and the gang members
the batched calls covered, `batched_members` and `mlp_batched_members`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from kafka_ps_tpu_torch.models import logreg, mlp
from kafka_ps_tpu_torch.ops import _build
from kafka_ps_tpu_torch.utils.config import ModelConfig

SOURCE = "local_update.cu"
MLP_SOURCE = "mlp_update.cu"
MAX_ROWS = 16          # classes + 1 the kernels take (kMaxRows in the .cu)
ROWS_PER_CTA = 32      # batch rows per CTA (kRowsPerCta in the .cu)
MAX_MEMBERS = 32       # gang members per kernel call (kMaxMembers)

launches = 0
batched_launches = 0
batched_members = 0
mlp_launches = 0
mlp_batched_launches = 0
mlp_batched_members = 0
_lock = threading.Lock()

_COUNTERS = ("launches", "batched_launches", "batched_members",
             "mlp_launches", "mlp_batched_launches", "mlp_batched_members")


def reset_counts() -> None:
    """Set every kernel counter to 0."""
    with _lock:
        for name in _COUNTERS:
            globals()[name] = 0


def counts() -> dict[str, int]:
    """The kernel counters, by name."""
    with _lock:
        return {name: globals()[name] for name in _COUNTERS}


# -- plain versions ------------------------------------------------------------


def local_update_plain(theta: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, mask: torch.Tensor, *,
                       cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's plain PyTorch version: k gradient steps as a Python loop,
    then the loss at the updated parameters."""
    return logreg.local_update(theta, x, y, mask, cfg=cfg)


def mlp_local_update_plain(theta: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor, mask: torch.Tensor, *,
                           cfg: ModelConfig
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's plain PyTorch version: the MLP's k closed-form gradient
    steps, then the loss at the updated parameters."""
    return mlp.local_update(theta, x, y, mask, cfg=cfg)


def _loop(single, thetas, xs, ys, masks, cfg):
    out = [single(t, x, y, m, cfg=cfg)
           for t, x, y, m in zip(thetas, xs, ys, masks)]
    return (torch.stack([d for d, _ in out]),
            torch.stack([loss for _, loss in out]))


def local_update_batched_plain(thetas, xs, ys, masks, *, cfg: ModelConfig
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's plain version: K1's plain version per member, stacked — equal
    to per-member calls bit for bit."""
    return _loop(local_update_plain, thetas, xs, ys, masks, cfg)


def mlp_local_update_batched_plain(thetas, xs, ys, masks, *,
                                   cfg: ModelConfig
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version: K4's plain version per member, stacked."""
    return _loop(mlp_local_update_plain, thetas, xs, ys, masks, cfg)


# -- argument checks -----------------------------------------------------------


def check_args(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor, cfg: ModelConfig,
               num_params: int | None = None) -> None:
    """What the kernels take: float32 theta/x/mask and int32 labels, all
    contiguous, on one device, shaped by cfg (theta of `num_params`,
    logreg's count unless given).  Raises otherwise."""
    if cfg.num_rows > MAX_ROWS:
        raise ValueError(f"the local update kernels take at most "
                         f"{MAX_ROWS - 1} classes, got {cfg.num_classes}")
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
    n = cfg.num_params if num_params is None else num_params
    if tuple(theta.shape) != (n,):
        raise ValueError(f"theta must be [{n}], got {tuple(theta.shape)}")
    if tuple(y.shape) != (batch,) or tuple(mask.shape) != (batch,):
        raise ValueError(f"y and mask must be [{batch}], got "
                         f"{tuple(y.shape)} and {tuple(mask.shape)}")


def _members(thetas, xs, ys, masks, cfg, num_params):
    """Per-member lists, each member checked, all on one device with one
    batch size."""
    thetas, xs, ys, masks = (list(a) for a in (thetas, xs, ys, masks))
    if not (len(thetas) == len(xs) == len(ys) == len(masks) >= 1):
        raise ValueError("a gang needs one theta, x, y and mask per member, "
                         f"got {len(thetas)}, {len(xs)}, {len(ys)}, "
                         f"{len(masks)}")
    for t, x, y, m in zip(thetas, xs, ys, masks):
        check_args(t, x, y, m, cfg, num_params)
        if x.device != xs[0].device or x.shape != xs[0].shape:
            raise ValueError("gang members must share device and batch "
                             f"shape, got {tuple(x.shape)} on {x.device} "
                             f"and {tuple(xs[0].shape)} on {xs[0].device}")
    return thetas, xs, ys, masks


# -- the kernels ---------------------------------------------------------------

_fns: dict = {}      # C symbol → configured ctypes function


def _entry(source: str, symbol: str, prefix: str, nargs_ptr: int,
           nargs_int: int):
    """A kernel's C entry point, its signature declared once and the
    compiled geometry checked against this module's constants."""
    with _lock:
        fn = _fns.get(symbol)
        if fn is None:
            lib = _build.load(source)
            geometry = (getattr(lib, f"{prefix}rows_per_cta")(),
                        getattr(lib, f"{prefix}max_rows")(),
                        getattr(lib, f"{prefix}max_members")())
            if geometry != (ROWS_PER_CTA, MAX_ROWS, MAX_MEMBERS):
                raise RuntimeError(f"{source} disagrees with fused_update.py "
                                   f"on ROWS_PER_CTA / MAX_ROWS / "
                                   f"MAX_MEMBERS: {geometry}")
            fn = getattr(lib, symbol)
            fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)] * 4
                           + [ctypes.c_int] + [ctypes.c_void_p] * nargs_ptr
                           + [ctypes.c_int] * nargs_int
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fns[symbol] = fn
        return fn


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _call(fn, thetas, xs, ys, masks, outputs, ints, cfg, name):
    """Run the kernel over the members in chunks of MAX_MEMBERS.
    `outputs` are flat tensors of k equal member blocks; a chunk gets the
    address of its first member's block (no per-chunk tensor slices)."""
    dev, k = xs[0].device, len(xs)
    blocks = [(o.data_ptr(), o.numel() // k * o.element_size())
              for o in outputs]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, k, MAX_MEMBERS):
            hi = min(lo + MAX_MEMBERS, k)
            err = fn(_pointers(thetas[lo:hi]), _pointers(xs[lo:hi]),
                     _pointers(ys[lo:hi]), _pointers(masks[lo:hi]),
                     hi - lo, *(base + lo * size for base, size in blocks),
                     *ints, cfg.num_max_iter, cfg.local_learning_rate,
                     stream)
            if err != 0:
                raise RuntimeError(f"{name} kernel launch failed: CUDA "
                                   f"error {err}")


# The scratch tensors of a launch are dropped when it returns, while its
# kernels may still run: the caching allocator hands their memory only to
# work queued later on the same stream, which runs after them.  Outputs
# come back flat: deltas [k*P], losses [k].


def _launch_logreg(thetas, xs, ys, masks, cfg: ModelConfig):
    fn = _entry(SOURCE, "kps_local_update", "kps_", 5, 4)
    k, (batch, features) = len(xs), xs[0].shape
    nblk = -(-batch // ROWS_PER_CTA)
    P = cfg.num_params
    f32 = dict(dtype=torch.float32, device=xs[0].device)
    deltas, losses = torch.empty(k * P, **f32), torch.empty(k, **f32)
    scratch = (torch.empty(k * P, **f32), torch.empty(k * nblk * P, **f32),
               torch.empty(k * nblk, **f32))
    _call(fn, thetas, xs, ys, masks, (deltas, losses, *scratch),
          (batch, features, cfg.num_rows), cfg, "local_update")
    return deltas, losses


def _launch_mlp(thetas, xs, ys, masks, cfg: ModelConfig):
    fn = _entry(MLP_SOURCE, "kps_mlp_local_update", "kps_mlp_", 7, 5)
    k, (batch, features) = len(xs), xs[0].shape
    nblk = -(-batch // ROWS_PER_CTA)
    H, R = cfg.hidden_dim, cfg.num_rows
    P = mlp.num_params(cfg)
    f32 = dict(dtype=torch.float32, device=xs[0].device)
    deltas, losses = torch.empty(k * P, **f32), torch.empty(k, **f32)
    scratch = (torch.empty(k * P, **f32), torch.empty(k * batch * H, **f32),
               torch.empty(k * batch * H, **f32),
               torch.empty(k * nblk * (H + R * H + R), **f32),
               torch.empty(k * nblk, **f32))
    _call(fn, thetas, xs, ys, masks, (deltas, losses, *scratch),
          (batch, features, H, R), cfg, "mlp_local_update")
    return deltas, losses


def _count(name: str, members: int = 0) -> None:
    with _lock:
        globals()[name] += 1
        if members:
            key = ("mlp_batched_members" if name.startswith("mlp")
                   else "batched_members")
            globals()[key] += members


# -- the wrappers --------------------------------------------------------------


def local_update(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 mask: torch.Tensor, *, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: k local solver steps on the buffer → (delta, loss at the
    updated parameters).  CUDA tensors go to the kernel, CPU tensors to
    the plain version; arguments are checked first either way."""
    check_args(theta, x, y, mask, cfg)
    if x.device.type != "cuda":
        return local_update_plain(theta, x, y, mask, cfg=cfg)
    delta, losses = _launch_logreg([theta], [x], [y], [mask], cfg)
    _count("launches")
    return delta, losses[0]


def local_update_batched(thetas, xs, ys, masks, *, cfg: ModelConfig
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: K1 for every gang member in one kernel call → (deltas [k, P],
    losses [k]); member i equals K1 on member i's inputs bitwise.  Members
    may share one theta tensor."""
    thetas, xs, ys, masks = _members(thetas, xs, ys, masks, cfg,
                                     cfg.num_params)
    if xs[0].device.type != "cuda":
        return local_update_batched_plain(thetas, xs, ys, masks, cfg=cfg)
    deltas, losses = _launch_logreg(thetas, xs, ys, masks, cfg)
    _count("batched_launches", len(xs))
    return deltas.view(len(xs), -1), losses


def mlp_local_update(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     mask: torch.Tensor, *, cfg: ModelConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: the MLP's k local solver steps → (delta, loss at the updated
    parameters).  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    check_args(theta, x, y, mask, cfg, mlp.num_params(cfg))
    if x.device.type != "cuda":
        return mlp_local_update_plain(theta, x, y, mask, cfg=cfg)
    delta, losses = _launch_mlp([theta], [x], [y], [mask], cfg)
    _count("mlp_launches")
    return delta, losses[0]


def mlp_local_update_batched(thetas, xs, ys, masks, *, cfg: ModelConfig
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6: K4 for every gang member in one kernel call → (deltas [k, P],
    losses [k]); member i equals K4 on member i's inputs bitwise."""
    thetas, xs, ys, masks = _members(thetas, xs, ys, masks, cfg,
                                     mlp.num_params(cfg))
    if xs[0].device.type != "cuda":
        return mlp_local_update_batched_plain(thetas, xs, ys, masks,
                                              cfg=cfg)
    deltas, losses = _launch_mlp(thetas, xs, ys, masks, cfg)
    _count("mlp_batched_launches", len(xs))
    return deltas.view(len(xs), -1), losses
