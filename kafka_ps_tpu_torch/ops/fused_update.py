"""The fused k-step local updates (counterpart of
kafka_ps_tpu/ops/fused_update.py), one wrapper per TPU kernel:

  K1 `local_update`              logreg, one worker   (`_kernel`)
  K2 `local_update_batched`      logreg, a gang       (grid over members)
  K3 `stream_update`             logreg, bf16 / int8 slab
                                 (`_stream_kernel`, `_stream_kernel_q`)
  K4 `mlp_local_update`          MLP, one worker      (`_mlp_kernel`)
  K5 `mlp_stream_update`         MLP, bf16 / int8 slab
                                 (`_mlp_stream_kernel(_q)`)
  K6 `mlp_local_update_batched`  MLP, a gang          (grid over members)

Each returns (delta, loss at the updated parameters), the contract of the
task's local update; the batched ones take per-member sequences (or
stacked tensors) and return (deltas [k, P], losses [k]).  x comes in any
stored form of the worker's slab (compress/slab.py): an f32 or bf16
tensor, or a QuantizedSlab.  `local_update` and `mlp_local_update`
dispatch on it as the JAX package's do: f32 to K1/K4, bf16 and int8 to
K3/K5; the batched wrappers take a gang of one form to K2/K6 or to the
batched K3/K5.  An f32 slab of any size is K1's (K4's): Hopper tiles every
batch across CTAs, so the TPU's oversize-f32 case of K3 (K5) needs no
kernel of its own, and `stream_update` (`mlp_stream_update`) hands an
f32 slab to K1 (K4).

For CUDA tensors a wrapper launches its hand-written kernel
(`csrc/local_update.cu` for K1/K2/K3, `csrc/mlp_update.cu` for K4/K5/K6,
built by `_build` on first use) or raises; for CPU tensors it runs the
kernel's plain PyTorch version beside it.  There is no fallback from the
card to the plain version, and no decode into an f32 copy before a K1/K4
launch: K3/K5 read a stored slab in its stored form.

K1 is the K2 kernel with one member, K4 the K6 kernel with one member,
and K3/K5 are those kernels' bf16 and int8 instances, so a gang member is
bitwise equal to a single call on its inputs by construction; the plain
batched versions are loops of the plain single versions, so the same
holds on the CPU.

K4/K5/K6 run their five B*F*H products on the tensor cores (TF32
mma.sync) at f32 accuracy: each f32 operand is split into two TF32 terms
(hi + lo) and a product summed from three (two where x is stored bf16 or
int8, which TF32 holds exactly; see the header of csrc/mlp_update.cu).
They sum in another order than the plain version, within rtol 1e-4,
atol 1e-5 of it.  K1/K2/K3 run as one cooperative persistent CUDA launch
per call, x resident in shared memory across the k steps (see the header
of csrc/local_update.cu).  Each library sizes its own scratch
(`kps_logreg_scratch`, `kps_mlp_scratch`), so the tilings stay in the
.cu files.

The counters count each wrapper's kernel calls (a logreg call is one CUDA
launch, an MLP call several — see the .cu files), so a run can show that
its main path went
through the kernels: `launches` (K1), `batched_launches` (K2),
`stream_launches` and `stream_batched_launches` (K3), `mlp_launches`
(K4), `mlp_batched_launches` (K6), `mlp_stream_launches` and
`mlp_stream_batched_launches` (K5), and for each batched counter the gang
members its calls covered (`..._members`).  A CUDA graph that captured
wrapper calls (the fused BSP chunk, parallel/bsp.py) adds them again at
each replay (`add_counts`).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from kafka_ps_tpu_torch.compress.slab import (QuantizedSlab,
                                              slab_batch_shape, slab_kind)
from kafka_ps_tpu_torch.models import logreg, mlp
from kafka_ps_tpu_torch.ops import _build
from kafka_ps_tpu_torch.utils.config import ModelConfig

SOURCE = "local_update.cu"
MLP_SOURCE = "mlp_update.cu"
MAX_ROWS = 16          # classes + 1 the kernels take (kMaxRows in the .cu)
MAX_MEMBERS = 32       # gang members per kernel call (kMaxMembers)

launches = 0
batched_launches = 0
batched_members = 0
stream_launches = 0
stream_batched_launches = 0
stream_batched_members = 0
mlp_launches = 0
mlp_batched_launches = 0
mlp_batched_members = 0
mlp_stream_launches = 0
mlp_stream_batched_launches = 0
mlp_stream_batched_members = 0
_lock = threading.Lock()

_COUNTERS = ("launches", "batched_launches", "batched_members",
             "stream_launches", "stream_batched_launches",
             "stream_batched_members",
             "mlp_launches", "mlp_batched_launches", "mlp_batched_members",
             "mlp_stream_launches", "mlp_stream_batched_launches",
             "mlp_stream_batched_members")


def reset_counts() -> None:
    """Set every kernel counter to 0."""
    with _lock:
        for name in _COUNTERS:
            globals()[name] = 0


def counts() -> dict[str, int]:
    """The kernel counters, by name."""
    with _lock:
        return {name: globals()[name] for name in _COUNTERS}


def add_counts(delta: dict[str, int]) -> None:
    """Add `delta` to the counters: a CUDA graph replay counts the kernel
    calls it captured (parallel/bsp.py), and a capture takes back what
    its wrapper calls counted, since capturing launches nothing."""
    with _lock:
        for name, n in delta.items():
            globals()[name] += n


# -- plain versions ------------------------------------------------------------


def local_update_plain(theta: torch.Tensor, x, y: torch.Tensor,
                       mask: torch.Tensor, *, cfg: ModelConfig
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's plain PyTorch version: k gradient steps as a Python loop,
    then the loss at the updated parameters.  With a stored slab it is
    K3's: logreg.local_update decodes it (decode_x) first."""
    return logreg.local_update(theta, x, y, mask, cfg=cfg)


def mlp_local_update_plain(theta: torch.Tensor, x, y: torch.Tensor,
                           mask: torch.Tensor, *, cfg: ModelConfig
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's plain PyTorch version: the MLP's k closed-form gradient
    steps, then the loss at the updated parameters.  With a stored slab
    it is K5's: mlp.local_update decodes it (decode_x) first."""
    return mlp.local_update(theta, x, y, mask, cfg=cfg)


def _loop(single, thetas, xs, ys, masks, cfg):
    out = [single(t, x, y, m, cfg=cfg)
           for t, x, y, m in zip(thetas, xs, ys, masks)]
    return (torch.stack([d for d, _ in out]),
            torch.stack([loss for _, loss in out]))


def local_update_batched_plain(thetas, xs, ys, masks, *, cfg: ModelConfig
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's (and the batched K3's) plain version: K1's plain version per
    member, stacked — equal to per-member calls bit for bit."""
    return _loop(local_update_plain, thetas, xs, ys, masks, cfg)


def mlp_local_update_batched_plain(thetas, xs, ys, masks, *,
                                   cfg: ModelConfig
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's (and the batched K5's) plain version: K4's plain version per
    member, stacked."""
    return _loop(mlp_local_update_plain, thetas, xs, ys, masks, cfg)


# -- argument checks -----------------------------------------------------------


def _x_tensors(x) -> tuple[torch.Tensor, ...]:
    return tuple(x) if isinstance(x, QuantizedSlab) else (x,)


def _x_device(x) -> torch.device:
    return _x_tensors(x)[0].device


def check_args(theta: torch.Tensor, x, y: torch.Tensor, mask: torch.Tensor,
               cfg: ModelConfig, num_params: int | None = None) -> str:
    """What the kernels take: float32 theta/mask and int32 labels, and x
    as a float32 or bfloat16 [B, F] tensor or a QuantizedSlab of int8 q
    [B, F] and float32 scale [B, 1]; all contiguous, on one device, shaped
    by cfg (theta of `num_params`, logreg's count unless given).  Returns
    the storage form ("f32", "bf16", "int8"); raises otherwise."""
    if cfg.num_rows > MAX_ROWS:
        raise ValueError(f"the local update kernels take at most "
                         f"{MAX_ROWS - 1} classes, got {cfg.num_classes}")
    kind = slab_kind(x)
    dev = _x_device(x)
    checks = [("theta", theta, torch.float32), ("y", y, torch.int32),
              ("mask", mask, torch.float32)]
    if kind == "int8":
        checks += [("x.q", x.q, torch.int8), ("x.scale", x.scale,
                                              torch.float32)]
    else:
        checks += [("x", x, x.dtype)]     # the dtype slab_kind accepted
    for name, t, dtype in checks:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got "
                            f"{getattr(t, 'dtype', type(t))}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    batch, features = slab_batch_shape(x)
    xt = _x_tensors(x)[0]
    if xt.ndim != 2 or features != cfg.num_features or batch < 1:
        raise ValueError(f"x must be [B>=1, {cfg.num_features}], "
                         f"got {tuple(xt.shape)}")
    if kind == "int8" and tuple(x.scale.shape) != (batch, 1):
        raise ValueError(f"x.scale must be [{batch}, 1], got "
                         f"{tuple(x.scale.shape)}")
    n = cfg.num_params if num_params is None else num_params
    if tuple(theta.shape) != (n,):
        raise ValueError(f"theta must be [{n}], got {tuple(theta.shape)}")
    if tuple(y.shape) != (batch,) or tuple(mask.shape) != (batch,):
        raise ValueError(f"y and mask must be [{batch}], got "
                         f"{tuple(y.shape)} and {tuple(mask.shape)}")
    return kind


def _unstack(xs):
    """Per-member slabs of a gang: a sequence as it is, a stacked tensor
    or a stacked QuantizedSlab ([k, B, F] and [k, B, 1]) split along the
    member axis."""
    if isinstance(xs, QuantizedSlab):
        return [QuantizedSlab(q, s) for q, s in zip(xs.q, xs.scale)]
    return list(xs)


def _members(thetas, xs, ys, masks, cfg, num_params):
    """Per-member lists, each member checked, all on one device with one
    storage form and one batch shape.  Returns them and the form."""
    thetas, ys, masks = (list(a) for a in (thetas, ys, masks))
    xs = _unstack(xs)
    if not (len(thetas) == len(xs) == len(ys) == len(masks) >= 1):
        raise ValueError("a gang needs one theta, x, y and mask per member, "
                         f"got {len(thetas)}, {len(xs)}, {len(ys)}, "
                         f"{len(masks)}")
    kinds = [check_args(t, x, y, m, cfg, num_params)
             for t, x, y, m in zip(thetas, xs, ys, masks)]
    if len(set(kinds)) > 1:
        raise TypeError(f"gang members must share one slab form, got "
                        f"{sorted(set(kinds))}")
    dev, shape = _x_device(xs[0]), slab_batch_shape(xs[0])
    for x in xs:
        if _x_device(x) != dev or slab_batch_shape(x) != shape:
            raise ValueError("gang members must share device and batch "
                             f"shape, got {slab_batch_shape(x)} on "
                             f"{_x_device(x)} and {shape} on {dev}")
    return thetas, xs, ys, masks, kinds[0]


# -- the kernels ---------------------------------------------------------------

_fns: dict = {}      # C symbol → configured ctypes function

# C entry per (family, storage form), and the pointer tables it takes
_SYMBOLS = {("logreg", "f32"): "kps_local_update",
            ("logreg", "bf16"): "kps_local_update_bf16",
            ("logreg", "int8"): "kps_local_update_q",
            ("mlp", "f32"): "kps_mlp_local_update",
            ("mlp", "bf16"): "kps_mlp_local_update_bf16",
            ("mlp", "int8"): "kps_mlp_local_update_q"}


def _geometry(lib, family: str) -> None:
    """Check a library's compiled class and member limits against this
    module's constants.  Each library sizes its own scratch
    (`_logreg_scratch`, `_mlp_scratch`)."""
    names = {"logreg": ("kps_max_rows", "kps_max_members"),
             "mlp": ("kps_mlp_max_rows", "kps_mlp_max_members")}[family]
    want = (MAX_ROWS, MAX_MEMBERS)
    got = tuple(getattr(lib, n)() for n in names)
    if got != want:
        raise RuntimeError(f"the {family} kernel disagrees with "
                           f"fused_update.py on {', '.join(names)}: {got}")


def _entry(source: str, symbol: str, family: str, tables: int,
           nargs_ptr: int, nargs_int: int):
    """A kernel's C entry point, its signature declared once and the
    compiled geometry checked against this module's constants."""
    with _lock:
        fn = _fns.get(symbol)
        if fn is None:
            lib = _build.load(source)
            _geometry(lib, family)
            fn = getattr(lib, symbol)
            fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)] * tables
                           + [ctypes.c_int] + [ctypes.c_void_p] * nargs_ptr
                           + [ctypes.c_int] * nargs_int
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fns[symbol] = fn
        return fn


def load(family: str, kind: str = "f32") -> None:
    """Build (nvcc, on first use) and load the kernel of one family and
    slab form, its geometry checked, without launching it: a process that
    must answer heartbeats builds before it connects."""
    source, ptrs, ints = ((SOURCE, 3, 4) if family == "logreg"
                          else (MLP_SOURCE, 7, 5))
    _entry(source, _SYMBOLS[family, kind], family,
           5 if kind == "int8" else 4, ptrs, ints)


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _tables(thetas, xs, ys, masks, kind):
    """The per-member pointer tables of a C entry: theta, x (q for int8),
    y, mask, and for int8 the row scales."""
    if kind != "int8":
        return [thetas, xs, ys, masks]
    return [thetas, [x.q for x in xs], ys, masks, [x.scale for x in xs]]


def _call(fn, tables, outputs, ints, cfg, name):
    """Run the kernel over the members in chunks of MAX_MEMBERS.
    `tables` are per-member tensor lists, one pointer table each;
    `outputs` are flat tensors of k equal member blocks; a chunk gets the
    address of its first member's block (no per-chunk tensor slices)."""
    dev, k = tables[0][0].device, len(tables[0])
    blocks = [(o.data_ptr(), o.numel() // k * o.element_size())
              for o in outputs]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, k, MAX_MEMBERS):
            hi = min(lo + MAX_MEMBERS, k)
            err = fn(*(_pointers(t[lo:hi]) for t in tables),
                     hi - lo, *(base + lo * size for base, size in blocks),
                     *ints, cfg.num_max_iter, cfg.local_learning_rate,
                     stream)
            if err != 0:
                raise RuntimeError(f"{name} kernel launch failed: CUDA "
                                   f"error {err}")


@functools.lru_cache(maxsize=64)
def _logreg_scratch(batch: int, features: int, rows: int,
                    members: int) -> int:
    """The floats of a logreg call's scratch on `members` members, as
    local_update.cu's tiling needs them (`kps_logreg_scratch`: W, the tile
    partials, the loss partials), summed: the wrapper allocates one tensor
    and the library lays the three out in it."""
    sizes = (ctypes.c_longlong * 3)()
    _build.load(SOURCE).kps_logreg_scratch(batch, features, rows, members,
                                           sizes)
    return sum(sizes)


_PLAN = ("grid", "tiles_per_cta", "smem", "resident", "chunk_cols",
         "chunks", "static_smem")


def logreg_plan(batch: int, features: int, rows: int, members: int,
                kind: str = "f32") -> dict[str, int]:
    """The cooperative launch a logreg call on `members` members would
    make on the current card (`kps_logreg_plan`): its grid, the batch
    tiles each CTA owns, the dynamic and static shared memory per CTA in
    bytes, whether x stays resident in shared memory for the call (1) or
    is re-staged at each step (0), and the columns and chunks a staged row
    is cut into.  Needs the card."""
    out = (ctypes.c_int * len(_PLAN))()
    err = _build.load(SOURCE).kps_logreg_plan(
        batch, features, rows, members, ("f32", "bf16", "int8").index(kind),
        out)
    if err != 0:
        raise RuntimeError(f"kps_logreg_plan failed: CUDA error {err}")
    return dict(zip(_PLAN, out))


# The scratch tensor of a launch is dropped when it returns, while its
# kernels may still run: the caching allocator hands its memory only to
# work queued later on the same stream, which runs after them.  Outputs
# come back flat: deltas [k*P], losses [k].


def _launch_logreg(thetas, xs, ys, masks, cfg: ModelConfig, kind: str):
    tables = _tables(thetas, xs, ys, masks, kind)
    fn = _entry(SOURCE, _SYMBOLS["logreg", kind], "logreg", len(tables), 3,
                4)
    k, (batch, features) = len(xs), slab_batch_shape(xs[0])
    R, P = cfg.num_rows, cfg.num_params
    f32 = dict(dtype=torch.float32, device=thetas[0].device)
    deltas, losses = torch.empty(k * P, **f32), torch.empty(k, **f32)
    scratch = torch.empty(_logreg_scratch(batch, features, R, k), **f32)
    _call(fn, tables, (deltas, losses, scratch), (batch, features, R), cfg,
          "local_update")
    return deltas, losses


def _mlp_scratch(batch: int, features: int, hidden: int, rows: int,
                 members: int) -> tuple[int, ...]:
    """The float counts of the MLP kernel's five scratch buffers (w, hid,
    dh, partials, loss_partials) for a call on `members` members, as
    mlp_update.cu's tiling needs them."""
    lib = _build.load(MLP_SOURCE)
    sizes = (ctypes.c_longlong * 5)()
    lib.kps_mlp_scratch(batch, features, hidden, rows, members, sizes)
    return tuple(sizes)


def _launch_mlp(thetas, xs, ys, masks, cfg: ModelConfig, kind: str):
    tables = _tables(thetas, xs, ys, masks, kind)
    fn = _entry(MLP_SOURCE, _SYMBOLS["mlp", kind], "mlp", len(tables), 7, 5)
    k, (batch, features) = len(xs), slab_batch_shape(xs[0])
    H, R = cfg.hidden_dim, cfg.num_rows
    P = mlp.num_params(cfg)
    f32 = dict(dtype=torch.float32, device=thetas[0].device)
    deltas, losses = torch.empty(k * P, **f32), torch.empty(k, **f32)
    scratch = tuple(torch.empty(n, **f32) for n in
                    _mlp_scratch(batch, features, H, R, k))
    _call(fn, tables, (deltas, losses, *scratch),
          (batch, features, H, R), cfg, "mlp_local_update")
    return deltas, losses


def _count(family: str, kind: str, members: int = 0) -> None:
    """One kernel call: K1/K2/K4/K6 for an f32 slab, K3/K5 for a stored
    one; `members` > 0 for a batched call."""
    name = (("" if family == "logreg" else "mlp_")
            + ("" if kind == "f32" else "stream_")
            + ("batched_" if members else ""))
    with _lock:
        globals()[name + "launches"] += 1
        if members:
            globals()[name + "members"] += members


# -- the wrappers --------------------------------------------------------------


def local_update(theta: torch.Tensor, x, y: torch.Tensor,
                 mask: torch.Tensor, *, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """k local solver steps on the buffer → (delta, loss at the updated
    parameters): K1 for an f32 slab, K3 for a bf16 or int8 one.  CUDA
    tensors go to the kernel, CPU tensors to the plain version; arguments
    are checked first either way."""
    kind = check_args(theta, x, y, mask, cfg)
    if _x_device(x).type != "cuda":
        return local_update_plain(theta, x, y, mask, cfg=cfg)
    delta, losses = _launch_logreg([theta], [x], [y], [mask], cfg, kind)
    _count("logreg", kind)
    return delta, losses[0]


def stream_update(theta: torch.Tensor, x, y: torch.Tensor,
                  mask: torch.Tensor, *, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 (JAX `_stream_update`): the logreg update on a slab in any
    storage form, decoded in the kernel.  An f32 slab, of any batch, runs
    K1, which tiles every batch across CTAs."""
    return local_update(theta, x, y, mask, cfg=cfg)


def local_update_batched(thetas, xs, ys, masks, *, cfg: ModelConfig
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 for a gang of f32 slabs, the batched K3 for a gang of bf16 or
    int8 ones: one kernel call for every member → (deltas [k, P], losses
    [k]); member i equals the single call on member i's inputs bitwise.
    Members may share one theta tensor; their slabs go to the kernel as
    per-member pointers, unstacked."""
    thetas, xs, ys, masks, kind = _members(thetas, xs, ys, masks, cfg,
                                           cfg.num_params)
    if _x_device(xs[0]).type != "cuda":
        return local_update_batched_plain(thetas, xs, ys, masks, cfg=cfg)
    deltas, losses = _launch_logreg(thetas, xs, ys, masks, cfg, kind)
    _count("logreg", kind, len(xs))
    return deltas.view(len(xs), -1), losses


def mlp_local_update(theta: torch.Tensor, x, y: torch.Tensor,
                     mask: torch.Tensor, *, cfg: ModelConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MLP's k local solver steps → (delta, loss at the updated
    parameters): K4 for an f32 slab, K5 for a bf16 or int8 one.  CUDA
    tensors go to the kernel, CPU tensors to the plain version."""
    kind = check_args(theta, x, y, mask, cfg, mlp.num_params(cfg))
    if _x_device(x).type != "cuda":
        return mlp_local_update_plain(theta, x, y, mask, cfg=cfg)
    delta, losses = _launch_mlp([theta], [x], [y], [mask], cfg, kind)
    _count("mlp", kind)
    return delta, losses[0]


def mlp_stream_update(theta: torch.Tensor, x, y: torch.Tensor,
                      mask: torch.Tensor, *, cfg: ModelConfig
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 (JAX `_mlp_stream_update`): the MLP update on a slab in any
    storage form, decoded in the kernel; an f32 slab runs K4."""
    return mlp_local_update(theta, x, y, mask, cfg=cfg)


def mlp_local_update_batched(thetas, xs, ys, masks, *, cfg: ModelConfig
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 for a gang of f32 slabs, the batched K5 for bf16 or int8 ones:
    one kernel call → (deltas [k, P], losses [k]); member i equals the
    single call on member i's inputs bitwise."""
    thetas, xs, ys, masks, kind = _members(thetas, xs, ys, masks, cfg,
                                           mlp.num_params(cfg))
    if _x_device(xs[0]).type != "cuda":
        return mlp_local_update_batched_plain(thetas, xs, ys, masks,
                                              cfg=cfg)
    deltas, losses = _launch_mlp(thetas, xs, ys, masks, cfg, kind)
    _count("mlp", kind, len(xs))
    return deltas.view(len(xs), -1), losses
